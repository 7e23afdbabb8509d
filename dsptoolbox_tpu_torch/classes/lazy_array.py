"""Lazy host returns of the getters (`dsptoolbox_tpu/classes/lazy_array.py`).

The reference returns plain numpy from `Signal.get_spectrum`, `get_csm` and
`get_spectrogram`; user code treats the result as numpy (``np.abs(sp)``,
assignment in place, pickling). A `LazyHostArray` keeps the value on its
device as the tensor the getter computed and copies it to the host only
when it is read there: metadata (``shape``, ``dtype``, ``ndim``, ``size``,
``len``) needs no copy, the first host access copies once (a complex value
as one packed ``(2, ...)`` real copy) and every later access sees the same
host buffer, so a change made in place persists, as on the reference's
return value. The library's own consumers (`transforms.istft`, `Spectrum`,
the beamformers) take the tensor (`device_tensor`) without a copy; once the
value has been copied to the host, the host buffer is the value, and they
take that.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LazyHostArray", "materialize_all"]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _host_value(re: torch.Tensor, im: torch.Tensor | None) -> np.ndarray:
    """One device → host copy: a real tensor as it is, a complex pair
    stacked into one ``(2, ...)`` real tensor first."""
    if im is None:
        return re.detach().cpu().numpy().copy()
    packed = torch.stack((re.detach(), im.detach())).cpu().numpy()
    out = np.empty(packed.shape[1:], np.result_type(packed.dtype, np.complex64))
    out.real, out.imag = packed[0], packed[1]
    return out


class LazyHostArray:
    """A getter's value on its device, copied to numpy at the first host
    access; see the module docstring. ``real``: a real tensor, or a complex
    one (kept as it is; ``imag`` None); ``imag``: the imaginary part of a
    complex value given as two real tensors."""

    # numpy defers its binary operators to ours
    __array_priority__ = 200

    def __init__(self, real: torch.Tensor, imag: torch.Tensor | None = None):
        if imag is None and real.is_complex():
            self._dev = real
            self._re, self._im = real.real, real.imag
        else:
            self._dev = None
            self._re, self._im = real, imag
        self._host = None

    # ----- metadata (no copy) -----------------------------------------
    @property
    def shape(self) -> tuple:
        return self._host.shape if self._host is not None else tuple(self._re.shape)

    @property
    def ndim(self) -> int:
        return self._host.ndim if self._host is not None else self._re.ndim

    @property
    def size(self) -> int:
        return self._host.size if self._host is not None else self._re.numel()

    @property
    def dtype(self) -> np.dtype:
        if self._host is not None:
            return self._host.dtype
        dt = np.dtype(_NP_DTYPES[self._re.dtype])
        return np.result_type(dt, np.complex64) if self._im is not None else dt

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # ----- the device value (no copy) ---------------------------------
    @property
    def is_materialized(self) -> bool:
        return self._host is not None

    @property
    def device(self) -> torch.device:
        return self._re.device

    def _from_host(self, part: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(part)).to(self._re.device)

    @property
    def device_real(self) -> torch.Tensor:
        """The real part as a tensor on the value's device: the getter's
        tensor, or once the value was copied to the host (and maybe changed
        there), the host buffer's."""
        if self._host is None:
            return self._re
        return self._from_host(self._host.real)

    @property
    def device_imag(self) -> torch.Tensor | None:
        """The imaginary part as `device_real` gives the real one; None for
        a real value."""
        if self._im is None:
            return None
        if self._host is None:
            return self._im
        return self._from_host(self._host.imag)

    def device_tensor(self) -> torch.Tensor:
        """The value as one tensor on its device (complex for a complex
        value): the getter's own tensor while the host has not been read,
        else the host buffer's."""
        if self._host is not None:
            return self._from_host(self._host)
        if self._dev is not None:
            return self._dev
        return self._re if self._im is None else torch.complex(self._re, self._im)

    # ----- the host value ---------------------------------------------
    def numpy(self) -> np.ndarray:
        """The host value: the first call copies it from the device (one
        copy), every later call returns the same writable buffer."""
        if self._host is None:
            self._host = _host_value(self._re, self._im)
        return self._host

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        if dtype is not None and out.dtype != np.dtype(dtype):
            return out.astype(dtype)
        return out.copy() if copy else out

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(i.numpy() if isinstance(i, LazyHostArray) else i for i in inputs)
        out = kwargs.get("out")
        if out is not None:
            kwargs["out"] = tuple(o.numpy() if isinstance(o, LazyHostArray) else o
                                  for o in out)
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __getattr__(self, name):
        # what is not defined here (T, real, imag, sum, conj, astype, ...)
        # comes from the host array
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.numpy(), name)

    def __getitem__(self, key):
        return self.numpy()[key]

    def __setitem__(self, key, value):
        self.numpy()[key] = value

    def __iter__(self):
        return iter(self.numpy())

    def __contains__(self, item):
        return item in self.numpy()

    def __repr__(self):
        if self._host is None:
            return (f"LazyHostArray(shape={self.shape}, dtype={self.dtype}, "
                    f"on {self.device})")
        return repr(self._host)

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __complex__(self):
        return complex(self.numpy())

    def __bool__(self):
        return bool(self.numpy())

    def __index__(self):
        return self.numpy().__index__()

    # ----- copies and pickling ----------------------------------------
    def copy(self) -> "LazyHostArray":
        """An independent array, as numpy's ``copy``: before any host
        access it shares the getter's tensors (the library never writes
        into a returned tensor), after it a copy of the host buffer."""
        other = LazyHostArray.__new__(LazyHostArray)
        other._dev, other._re, other._im = self._dev, self._re, self._im
        other._host = None if self._host is None else self._host.copy()
        return other

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        out = self.copy()
        memo[id(self)] = out
        return out

    def __reduce__(self):
        # pickles as the numpy array the reference would have returned
        return (np.asarray, (self.numpy().copy(),))

    __hash__ = None


def _binop(name):
    def op(self, other):
        if isinstance(other, LazyHostArray):
            other = other.numpy()
        return getattr(self.numpy(), name)(other)

    op.__name__ = name
    return op


for _name in (
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
    "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow", "matmul",
    "rmatmul", "and", "rand", "or", "ror", "xor", "rxor", "lshift",
    "rlshift", "rshift", "rrshift", "divmod", "rdivmod",
    "lt", "le", "gt", "ge", "eq", "ne",
):
    setattr(LazyHostArray, f"__{_name}__", _binop(f"__{_name}__"))

for _name in ("neg", "pos", "abs", "invert"):
    def _unop(self, _n=f"__{_name}__"):
        return getattr(self.numpy(), _n)()

    _unop.__name__ = f"__{_name}__"
    setattr(LazyHostArray, f"__{_name}__", _unop)


def materialize_all(*values) -> tuple:
    """Several values on the host at once, in call order: the device work
    is waited for once, then each lazy value is copied (one copy a value);
    host values pass through."""
    for dev in {v.device for v in values if isinstance(v, LazyHostArray)
                and not v.is_materialized and v.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tuple(v.numpy() if isinstance(v, LazyHostArray) else np.asarray(v) for v in values)
