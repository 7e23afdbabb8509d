"""Fused execution of chains of public calls (`dsptoolbox_tpu/pipeline.py`).

Every public call issues its own kernels from the host, so a chain of them
(`get_spectrogram` → `transforms.istft` → `get_spectrum` →
`append_signals` → `get_csm`) pays the host's time per operation even when
nothing is read back. :func:`pipeline` takes a user function of
:class:`~dsptoolbox_tpu_torch.classes.Signal` objects and, on a CUDA
device, captures the whole chain THROUGH the public class layer into ONE
CUDA graph, replayed on every later call: the host then issues one launch
and a few copies per call.

Usage::

    import dsptoolbox_tpu_torch as dsp

    def chain(s):
        t, f, S = s.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=s)
        f2, sp = s.get_spectrum(force_computation=True)
        two = dsp.append_signals([s, y])
        f3, C = two.get_csm(force_computation=True)
        return y, sp, C

    run = dsp.pipeline(chain)
    y, sp, C = run(sig)          # one CUDA graph replay on a CUDA signal

On a CUDA input, per input signature (below): ``fn`` runs once eagerly on a
side stream (the warm-up: it builds the kernels, the cuFFT plans and the
cached device constants), then once more under `torch.cuda.graph` on static
copies of the inputs (the capture); every call copies its inputs into the
static buffers, replays the graph and rebuilds the results from CLONES of
the graph's outputs, so two calls' results never share memory. ``fn`` runs
at most twice per signature and never on a replay. On a CPU input ``fn``
runs eagerly on every call. Either way it runs under
`_config.pipeline_context`, so the class layer takes the same in-pipeline
branches on both devices: a signal's amplitude constraint runs in-program
(no over-0-dBFS warning; ``amplitude_scale_factor`` stays 1), a filter
bank's peaks and `spectral_deconvolve`'s automatic regularization range
stay on the device.

The captured function must stay on the library's device paths: anything
that reads a value back to the host (``float(...)``, ``.tolist()``,
printing a sample, a branch on data) or copies from pageable host memory
raises while capturing, naming the line, as JAX fails with a
concretization error; the runner never carries on eagerly. Supported
return structures: (nests in tuples, lists and dicts of) `Signal`,
`ImpulseResponse` (a window it carries as a tensor travels as an output),
`MultiBandSignal`, tensors, and host constants computed from metadata
(frequency vectors, scalars, enums), which are captured with the graph.
Any other object of this package (a `Spectrum`, say) raises `TypeError`:
handed out as a constant, its tensors would be overwritten by the next
replay.

The cache key of a signature is every input's class, shape, dtype,
device, imaginary plane, sampling rate, ``constrain_amplitude``, spectrum
and spectrogram parameters and its analysis window (hashed by value; a
device window is fetched once per buffer and version, outside any
capture). Each signature keeps its own graph and memory pool.

``mesh`` (a `parallel.Mesh`): the runner places its inputs on the mesh's
first device and captures the chain there, keyed on that device: meshes
that share their first device share the captures.
torch has no pass that partitions a captured chain over devices (the JAX
package's XLA program is partitioned by GSPMD), and a chain such as
`get_csm` mixes the channels, so the chain runs whole on that device: the
JAX package's own behaviour for inputs whose channel count the mesh does
not divide. ``partition`` is accepted for the JAX signature and changes
nothing.
"""

from __future__ import annotations

import enum
import traceback

import numpy as np
import torch

from . import _config

__all__ = ["pipeline"]


def _freeze(v):
    """Hashable fingerprint of a metadata value (scalars, enums, nests,
    small arrays). Used only for cache keys, never for computation."""
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("arr", v.shape, str(v.dtype), hash(v.tobytes()))
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_freeze(x) for x in v))
    return v


def _window_fingerprint(sig):
    """Value-hash of a signal's analysis window without repeated device
    fetches: a host array hashes directly; a tensor (from `window_ir`) is
    fetched ONCE per buffer and version and the hash is cached on the
    signal (which keeps the buffer alive, so its id stays valid)."""
    w = getattr(sig, "window", None)
    if w is None or not torch.is_tensor(w):
        return None if w is None else ("w",) + _freeze(np.asarray(w))[1:]
    cache = sig.__dict__.setdefault("_pipeline_window_fp", {})
    key = (id(w), w._version)
    fp = cache.get(key)
    if fp is None:
        fp = ("w",) + _freeze(w)[1:]
        cache.clear()  # one window at a time per signal
        cache[key] = fp
    return fp


def _signal_signature(s):
    """Everything about a Signal that can change the captured work or the
    host constants captured with it."""
    return (
        type(s).__name__,
        tuple(s._x.shape),
        str(s._x.dtype),
        str(s._x.device),
        s._x_imag is not None,
        s.sampling_rate_hz,
        s.constrain_amplitude,
        _freeze(getattr(s, "_spectrum_parameters", None)),
        _freeze(getattr(s, "_spectrogram_parameters", None)),
        _window_fingerprint(s),
    )


def _flatten_result(obj, leaves, path="out"):
    """Recursively split ``obj`` into tensor leaves + a rebuild spec."""
    from .classes.multibandsignal import MultiBandSignal
    from .classes.signal import Signal

    if isinstance(obj, MultiBandSignal):
        band_specs = [
            _flatten_result(b, leaves, f"{path}.bands[{i}]")
            for i, b in enumerate(obj.bands)
        ]
        # metadata snapshot only: never retain the container
        return ("mbs", obj.same_sampling_rate, dict(obj.info), band_specs)
    if isinstance(obj, Signal):
        idx_re = len(leaves)
        leaves.append(obj._x)
        idx_im = None
        if obj._x_imag is not None:
            idx_im = len(leaves)
            leaves.append(obj._x_imag)
        idx_win = None
        if torch.is_tensor(getattr(obj, "window", None)):
            # a device-built analysis window (`window_ir`) is an output too,
            # so the rebuilt IR keeps it
            idx_win = len(leaves)
            leaves.append(obj.window)
        return ("signal", obj, idx_re, idx_im, idx_win)
    if torch.is_tensor(obj):
        leaves.append(obj)
        return ("tensor", len(leaves) - 1)
    if isinstance(obj, (tuple, list)):
        kind = "tuple" if isinstance(obj, tuple) else "list"
        return (kind, [_flatten_result(o, leaves, f"{path}[{i}]") for i, o in enumerate(obj)])
    if isinstance(obj, dict):
        return ("dict", {k: _flatten_result(v, leaves, f"{path}[{k!r}]") for k, v in obj.items()})
    if type(obj).__module__.split(".")[0] == __package__ and not isinstance(obj, enum.Enum):
        raise TypeError(
            f"pipeline result {path} is a {type(obj).__name__}, which a pipeline cannot "
            "return: return its tensors instead (a Spectrum's spectral_data, say)"
        )
    # a host constant (frequency vector, scalar, enum, ...), kept as it was
    # made when the chain ran: it must derive from metadata, not from data
    return ("const", obj)


def _rebuild_signal(template, td, td_imag):
    """A new Signal/ImpulseResponse around the tensors ``td`` (and
    ``td_imag``), channels-first, with the template's metadata. The
    template's own buffers are never read; the amplitude constraint is not
    applied again: the chain applied it already."""
    from .classes.signal import DeviceTimeData

    old = template.constrain_amplitude
    template.constrain_amplitude = False
    try:
        out = template.copy_with_new_time_data(
            DeviceTimeData(td.T, None if td_imag is None else td_imag.T)
        )
    finally:
        template.constrain_amplitude = old
    out.constrain_amplitude = old
    # a host analysis window travels as it is
    w = getattr(template, "window", None)
    if w is not None and not torch.is_tensor(w) and hasattr(out, "set_window"):
        out.set_window(w)
    return out


def _rebuild(spec, leaves):
    kind = spec[0]
    if kind == "mbs":
        from .classes.multibandsignal import MultiBandSignal

        _, same_sr, info, band_specs = spec
        return MultiBandSignal(
            [_rebuild(s, leaves) for s in band_specs],
            same_sampling_rate=same_sr,
            info=dict(info),
        )
    if kind == "signal":
        _, template, i_re, i_im, i_win = spec
        out = _rebuild_signal(template, leaves[i_re], None if i_im is None else leaves[i_im])
        if i_win is not None:
            out.set_window(leaves[i_win])
        return out
    if kind == "tensor":
        return leaves[spec[1]]
    if kind == "tuple":
        return tuple(_rebuild(s, leaves) for s in spec[1])
    if kind == "list":
        return [_rebuild(s, leaves) for s in spec[1]]
    if kind == "dict":
        return {k: _rebuild(s, leaves) for k, s in spec[1].items()}
    return spec[1]  # const


def _sanitize_spec(spec):
    """Drop the captured buffers from the kept Signal templates: they are
    kept for their metadata only (`_rebuild_signal` never reads their
    data), and their tensors, caches and windows belong to the graph's
    pool."""
    kind = spec[0]
    if kind == "mbs":
        for s in spec[3]:
            _sanitize_spec(s)
    elif kind == "signal":
        template = spec[1]
        placeholder = torch.zeros((1, 1), dtype=template._x.dtype, device=template._x.device)
        template._x = placeholder
        if template._x_imag is not None:
            template._x_imag = placeholder
        template._cache.clear()
        if torch.is_tensor(template.__dict__.get("window")):
            del template.window
    elif kind in ("tuple", "list"):
        for s in spec[1]:
            _sanitize_spec(s)
    elif kind == "dict":
        for s in spec[1].values():
            _sanitize_spec(s)


def _shells(signals, planes):
    """The signals ``fn`` gets: each input's settings around the tensors
    ``planes`` (real, imag) — views, or the constraint's in-program copy."""
    from .classes.signal import DeviceTimeData

    return [
        sig.copy_with_new_time_data(DeviceTimeData(re.T, None if im is None else im.T))
        for sig, (re, im) in zip(signals, planes)
    ]


def _host_read_site(err: BaseException) -> str:
    """``file:line: code`` of the innermost frame outside torch in ``err``'s
    traceback: the operation that failed, a host read say."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "/torch/" not in f.filename]
    if not frames:
        return "an operation inside torch"
    f = frames[-1]
    return f"{f.filename}:{f.lineno}: {f.line}"


class _Capture:
    """One signature's graph: the static inputs it reads, the output
    leaves it writes, the rebuild spec and the device constants it reads
    (`_config.retain`)."""

    def __init__(self, graph, inputs, leaves, spec, retained):
        self.graph, self.inputs, self.leaves = graph, inputs, leaves
        self.spec, self.retained = spec, retained


class Pipeline:
    """The runner `pipeline` returns: call it with the function's Signal
    arguments. ``captures`` maps each input signature to its `_Capture`."""

    def __init__(self, fn, mesh=None, partition=None):
        from .parallel import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
        self.fn = fn
        self.mesh = mesh
        self.captures: dict = {}
        self.__name__ = f"pipeline({getattr(fn, '__name__', 'fn')})"

    def __call__(self, *signals):
        from .classes.signal import Signal

        if not signals or not all(isinstance(s, Signal) for s in signals):
            raise TypeError("pipeline runners take Signal positional arguments")
        dev = self._device(signals)
        if dev.type != "cuda":
            with _config.pipeline_context():
                leaves: list = []
                planes = [(s._x.to(dev), None if s._x_imag is None else s._x_imag.to(dev))
                          for s in signals]
                spec = _flatten_result(self.fn(*_shells(signals, planes)), leaves)
            return _rebuild(spec, leaves)
        key = self._key(signals)
        with torch.cuda.device(dev):
            cap = self.captures.get(key)
            if cap is None:
                cap = self.captures[key] = self._capture(signals, dev)
            for (re, im), s in zip(cap.inputs, signals):
                re.copy_(s._x)
                if im is not None:
                    im.copy_(s._x_imag)
            cap.graph.replay()
            return _rebuild(cap.spec, [t.clone() for t in cap.leaves])

    def _device(self, signals) -> torch.device:
        """The device the chain runs on: the mesh's first, else the
        signals' own."""
        if self.mesh is not None:
            return torch.device(self.mesh.devices.flat[0])
        devices = {s.device for s in signals}
        if len(devices) != 1:
            raise ValueError(f"{self.__name__}: the signals lie on several devices {devices}")
        return devices.pop()

    def _key(self, signals) -> tuple:
        """The capture cache's key: the target device and each signal's
        signature."""
        return (str(self._device(signals)),) + tuple(_signal_signature(s) for s in signals)

    def _capture(self, signals, dev) -> _Capture:
        inputs = [(s._x.to(dev, copy=True),
                   None if s._x_imag is None else s._x_imag.to(dev, copy=True))
                  for s in signals]

        def run():
            leaves: list = []
            spec = _flatten_result(self.fn(*_shells(signals, inputs)), leaves)
            return spec, leaves

        # the warm-up, eager on a side stream: builds the kernels, the cuFFT
        # plans and the cached device constants that the capture reuses
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side), _config.pipeline_context():
            run()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        retained: list = []
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.graph(graph):
                # a host read or a pageable copy raises before it reaches
                # the stream, so the capture ends cleanly
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with _config.pipeline_context(retained):
                        spec, leaves = run()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except RuntimeError as err:
            raise RuntimeError(
                f"{self.__name__} could not be captured into a CUDA graph at "
                f"{_host_read_site(err)}: {err}. A captured chain must not read values "
                "back to the host or copy from host memory."
            ) from err
        _sanitize_spec(spec)
        return _Capture(graph, inputs, leaves, spec, retained)

    def graph_pool_bytes(self) -> int:
        """Device memory held by the graphs' pools: the segments of
        `torch.cuda.memory_snapshot` that belong to them."""
        pools = {tuple(c.graph.pool()) for c in self.captures.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)


def pipeline(fn, mesh=None, partition=None) -> Pipeline:
    """Run a chain of public calls on Signals as one CUDA graph (see the
    module docstring): ``fn`` takes one or more `Signal` (or subclass)
    positional arguments; the returned runner has the same signature.
    ``mesh``: a `parallel.Mesh`; the chain then runs on its first device
    (see the module docstring). ``partition`` is accepted and unused."""
    return Pipeline(fn, mesh, partition)
