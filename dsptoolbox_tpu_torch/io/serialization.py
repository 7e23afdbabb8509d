"""Object archives without pickle: arrays in a numpy ``.npz``, the rest in
one JSON record (`dsptoolbox_tpu/io/serialization.py`, same format and
keys, so an archive written by either package loads in the other).

Arrays leave the device once, at `save_object`; `load_object` builds the
object from host arrays, which go to `_config.default_device()` as any
numpy data does. Loading never executes code from the file.

Supported types: ``Signal``, ``ImpulseResponse``, ``MultiBandSignal``,
``Filter``, ``FilterBank``, ``Spectrum``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_object", "load_object"]

_FORMAT_VERSION = 1


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _jsonable(d: dict) -> dict:
    """The JSON-serializable entries of an info dict."""
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
        except TypeError:
            continue
        out[str(k)] = v
    return out


def _ensure_npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


# Each encoder returns (meta, arrays); array keys carry prefixes so that
# containers nest.


def _encode_signal(sig, prefix: str = "") -> tuple[dict, dict]:
    td = sig.time_data
    if sig.is_complex_signal:
        td = torch.complex(td, sig.time_data_imaginary)
    meta = {
        "kind": type(sig).__name__,
        "sampling_rate_hz": int(sig.sampling_rate_hz),
        "constrain_amplitude": bool(sig.constrain_amplitude),
        "calibrated_signal": bool(getattr(sig, "calibrated_signal", False)),
        "activate_cache": bool(getattr(sig, "activate_cache", False)),
    }
    arrays = {prefix + "time_data": _host(td)}
    window = getattr(sig, "window", None)
    if window is not None:
        arrays[prefix + "window"] = _host(window)
        meta["has_window"] = True
    return meta, arrays


def _decode_signal(meta: dict, arrays: dict, prefix: str = ""):
    from ..classes import ImpulseResponse, Signal

    cls = ImpulseResponse if meta["kind"] == "ImpulseResponse" else Signal
    sig = cls.from_time_data(
        arrays[prefix + "time_data"], meta["sampling_rate_hz"], meta["constrain_amplitude"]
    )
    sig.calibrated_signal = meta.get("calibrated_signal", False)
    sig.activate_cache = meta.get("activate_cache", False)
    if meta.get("has_window"):
        sig.window = arrays[prefix + "window"]
    return sig


def _encode_filter(filt, prefix: str = "") -> tuple[dict, dict]:
    meta = {
        "kind": "Filter",
        "sampling_rate_hz": int(filt.sampling_rate_hz),
        "warning_if_complex": bool(getattr(filt, "warning_if_complex", True)),
    }
    arrays: dict = {}
    # the representation the filter was built from: zpk (sos derived from
    # it), ba (an FIR stays exactly ba) or sos
    for rep in ("zpk", "ba", "sos"):
        try:
            coeffs = getattr(filt, rep)
        except AttributeError:
            continue
        meta["representation"] = rep
        if rep == "zpk":
            z, p, k = coeffs
            arrays[prefix + "z"] = np.asarray(z)
            arrays[prefix + "p"] = np.asarray(p)
            arrays[prefix + "k"] = np.asarray(k)
        elif rep == "ba":
            arrays[prefix + "b"] = np.asarray(coeffs[0])
            arrays[prefix + "a"] = np.asarray(coeffs[1])
        else:
            arrays[prefix + "sos"] = np.asarray(coeffs)
        break
    else:
        raise ValueError("Filter holds no zpk/sos/ba coefficients")
    info = getattr(filt, "info", None)
    if isinstance(info, dict):
        meta["info"] = _jsonable(info)
    return meta, arrays


def _decode_filter(meta: dict, arrays: dict, prefix: str = ""):
    from ..classes import Filter

    fs = meta["sampling_rate_hz"]
    rep = meta["representation"]
    if rep == "zpk":
        filt = Filter.from_zpk(arrays[prefix + "z"], arrays[prefix + "p"],
                               arrays[prefix + "k"], fs)
    elif rep == "ba":
        filt = Filter.from_ba(arrays[prefix + "b"], arrays[prefix + "a"], fs)
    else:
        filt = Filter.from_sos(arrays[prefix + "sos"], fs)
    filt.warning_if_complex = meta.get("warning_if_complex", True)
    return filt


def _encode_multiband(mb, prefix: str = "") -> tuple[dict, dict]:
    meta = {
        "kind": "MultiBandSignal",
        "same_sampling_rate": bool(mb.same_sampling_rate),
        "info": _jsonable(getattr(mb, "info", {}) or {}),
        "bands": [],
    }
    arrays: dict = {}
    for n, band in enumerate(mb.bands):
        bmeta, barrs = _encode_signal(band, prefix=f"{prefix}b{n}__")
        meta["bands"].append(bmeta)
        arrays.update(barrs)
    return meta, arrays


def _decode_multiband(meta: dict, arrays: dict, prefix: str = ""):
    from ..classes import MultiBandSignal

    bands = [_decode_signal(bmeta, arrays, prefix=f"{prefix}b{n}__")
             for n, bmeta in enumerate(meta["bands"])]
    return MultiBandSignal(bands, same_sampling_rate=meta["same_sampling_rate"],
                           info=meta.get("info", {}))


def _encode_filterbank(fb, prefix: str = "") -> tuple[dict, dict]:
    meta = {
        "kind": "FilterBank",
        "same_sampling_rate": bool(fb.same_sampling_rate),
        "info": _jsonable(getattr(fb, "info", {}) or {}),
        "filters": [],
    }
    arrays: dict = {}
    for n, filt in enumerate(fb.filters):
        fmeta, farrs = _encode_filter(filt, prefix=f"{prefix}f{n}__")
        meta["filters"].append(fmeta)
        arrays.update(farrs)
    return meta, arrays


def _decode_filterbank(meta: dict, arrays: dict, prefix: str = ""):
    from ..classes import FilterBank

    filters = [_decode_filter(fmeta, arrays, prefix=f"{prefix}f{n}__")
               for n, fmeta in enumerate(meta["filters"])]
    return FilterBank(filters, same_sampling_rate=meta["same_sampling_rate"],
                      info=meta.get("info", {}))


def _encode_spectrum(spec, prefix: str = "") -> tuple[dict, dict]:
    meta = {"kind": "Spectrum"}
    arrays = {
        prefix + "frequency_vector_hz": np.asarray(spec.frequency_vector_hz),
        prefix + "spectral_data": _host(spec.spectral_data),
    }
    if getattr(spec, "has_coherence", False):
        arrays[prefix + "coherence"] = _host(spec.coherence)
        meta["has_coherence"] = True
    return meta, arrays


def _decode_spectrum(meta: dict, arrays: dict, prefix: str = ""):
    from ..classes import Spectrum

    spec = Spectrum(arrays[prefix + "frequency_vector_hz"], arrays[prefix + "spectral_data"])
    if meta.get("has_coherence"):
        spec.set_coherence(arrays[prefix + "coherence"])
    return spec


_ENCODERS = {
    "Signal": _encode_signal,
    "ImpulseResponse": _encode_signal,
    "MultiBandSignal": _encode_multiband,
    "Filter": _encode_filter,
    "FilterBank": _encode_filterbank,
    "Spectrum": _encode_spectrum,
}
_DECODERS = {
    "Signal": _decode_signal,
    "ImpulseResponse": _decode_signal,
    "MultiBandSignal": _decode_multiband,
    "Filter": _decode_filter,
    "FilterBank": _decode_filterbank,
    "Spectrum": _decode_spectrum,
}


def save_object(obj, path: str) -> str:
    """Save a supported object to ``path`` (``.npz`` appended if missing);
    returns the path written."""
    name = type(obj).__name__
    if name not in _ENCODERS:
        raise TypeError(
            f"Unsupported type for safe persistence: {name}. Supported: {sorted(_DECODERS)}"
        )
    meta, arrays = _ENCODERS[name](obj)
    meta["format_version"] = _FORMAT_VERSION
    path = _ensure_npz(path)
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path


def load_object(path: str):
    """Load an object saved by `save_object` (in either package)."""
    path = _ensure_npz(path)
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["__meta__"][()]))
        arrays = {k: npz[k] for k in npz.files if k != "__meta__"}
    kind = meta.get("kind")
    if kind not in _DECODERS:
        raise ValueError(f"Unknown object kind in archive: {kind!r}")
    return _DECODERS[kind](meta, arrays)
