"""ArBB-style dense containers on PyTorch.

The counterpart of ``repro.core.containers``.  ``Dense`` wraps a
``torch.Tensor`` and carries the ArBB operator vocabulary (element-wise
arithmetic, ``row``/``col`` accessors, sections, reductions).  The ArBB
two-space model maps onto host memory and the card:

    bind(A, host_array)   ->  bind(host_array)       (host -> device copy)
    A.read_only_range()   ->  A.read()               (device -> host copy)

Device rule: containers live on ``cuda`` unless the caller asks for
``device="cpu"``.  Without a card, a request that names no device raises;
nothing quietly runs on the CPU.

Dtype rule: ``bind`` narrows float64 to float32 and complex128 to complex64
unless a ``dtype`` is given, as ``jnp.asarray`` does with x64 off (the
paper's input generators return float64).

Every operation is functional and returns a new ``Dense``, as in the JAX
package, so the numerics layer reads the same in both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "Dense",
    "bind",
    "f32",
    "f64",
    "i32",
    "i64",
    "usize",
    "is_dense",
    "unwrap",
    "wrap",
    "resolve_device",
    "narrow_dtype",
    "to_device",
]

# ArBB scalar type aliases (paper §3.1: "ArBB defines special scalar data
# types like i32, f32 or f64").
f32 = torch.float32
f64 = torch.float64
i32 = torch.int32
i64 = torch.int64
usize = torch.int32

_NARROW = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def resolve_device(device: Any = None) -> torch.device:
    """The device a new container goes to: ``device`` when given, else the
    card.  Raises when no card is present and the caller named none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to place data on the host explicitly")
    return torch.device("cuda")


def narrow_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 -> float32, complex128 -> complex64, others unchanged."""
    return _NARROW.get(dtype, dtype)


def to_device(host_array: Any, dtype: Any = None, device: Any = None
              ) -> torch.Tensor:
    """``host_array`` (numpy, anything ``numpy.array`` reads, or a tensor)
    on the device ``resolve_device(device)`` names, in ``dtype`` or else its
    own dtype narrowed by :func:`narrow_dtype`.  Host arrays are copied; a
    tensor that already matches is returned as it is."""
    if isinstance(host_array, torch.Tensor):
        t = host_array
    else:
        t = torch.from_numpy(np.array(host_array))
    return t.to(device=resolve_device(device), dtype=dtype if dtype is not None
                else narrow_dtype(t.dtype))


def unwrap(x: Any) -> Any:
    """Return the underlying tensor of a Dense, or x unchanged."""
    return x.data if isinstance(x, Dense) else x


def wrap(x: Any) -> "Dense":
    """Wrap a tensor (or a Python scalar) into a Dense container.

    Host arrays are refused: they have no device, and ``bind`` is the one
    place that chooses one."""
    if isinstance(x, Dense):
        return x
    if isinstance(x, torch.Tensor):
        return Dense(x)
    if isinstance(x, (bool, int, float, complex)):
        return Dense(torch.as_tensor(x))
    raise TypeError(f"wrap() takes a Dense or a torch.Tensor, got "
                    f"{type(x).__name__}; use bind() to move host data")


def is_dense(x: Any) -> bool:
    return isinstance(x, Dense)


def _key(idx: Any) -> Any:
    """An index with any Dense parts unwrapped."""
    return tuple(unwrap(i) for i in idx) if isinstance(idx, tuple) \
        else unwrap(idx)


@dataclasses.dataclass(frozen=True)
class Dense:
    """An ArBB ``dense<T, D>`` container (D = 1..3) backed by a tensor."""

    data: torch.Tensor

    # -- construction / host interop (bind / read) --------------------------
    @classmethod
    def bind(cls, host_array: Any, *, dtype: Any = None,
             device: Any = None) -> "Dense":
        """ArBB ``bind()``: copy a host array onto the device (paper §3.1
        lines 19-21).  See the module docstring for the device and dtype
        rules."""
        return cls(to_device(host_array, dtype, device))

    @classmethod
    def zeros(cls, shape: Sequence[int] | int, dtype: Any = f32, *,
              device: Any = None) -> "Dense":
        return cls(torch.zeros(shape, dtype=dtype,
                               device=resolve_device(device)))

    @classmethod
    def full(cls, shape: Sequence[int] | int, value: Any, dtype: Any = f32,
             *, device: Any = None) -> "Dense":
        return cls(torch.full(shape if isinstance(shape, (tuple, list))
                              else (shape,), value, dtype=dtype,
                              device=resolve_device(device)))

    @classmethod
    def arange(cls, n: int, dtype: Any = i32, *, device: Any = None
               ) -> "Dense":
        return cls(torch.arange(n, dtype=dtype,
                                device=resolve_device(device)))

    def read(self) -> np.ndarray:
        """ArBB ``read_only_range()``: synchronise and copy to the host.
        bf16 has no numpy type and reads back as float32."""
        t = self.data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    # -- shape protocol ------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return int(self.data.numel())

    def __len__(self) -> int:
        return self.data.shape[0]

    # -- ArBB accessors ------------------------------------------------------
    def row(self, i) -> "Dense":
        """i-th row of a 2-D container."""
        return Dense(self.data[unwrap(i)])

    def col(self, j) -> "Dense":
        """j-th column of a 2-D container."""
        return Dense(self.data[:, unwrap(j)])

    def __getitem__(self, idx) -> "Dense":
        return Dense(self.data[_key(idx)])

    def set(self, idx, value) -> "Dense":
        """Functional element write: ArBB ``c(i, j) = v`` becomes
        ``c = c.set((i, j), v)``; the original is left untouched."""
        out = self.data.clone()
        out[_key(idx)] = unwrap(value)
        return Dense(out)

    def add_at(self, idx, value) -> "Dense":
        out = self.data.clone()
        out[_key(idx)] += unwrap(value)
        return Dense(out)

    def astype(self, dtype) -> "Dense":
        return Dense(self.data.to(dtype))

    def reshape(self, *shape) -> "Dense":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Dense(self.data.reshape(shape))

    @property
    def T(self) -> "Dense":
        return Dense(self.data.T)

    # -- element-wise arithmetic (ArBB operator overloading, paper §2) -------
    def _binop(self, other, op) -> "Dense":
        return Dense(op(self.data, unwrap(other)))

    def _rbinop(self, other, op) -> "Dense":
        return Dense(op(unwrap(other), self.data))

    def __add__(self, o):
        return self._binop(o, torch.add)

    def __radd__(self, o):
        return self._rbinop(o, torch.add)

    def __sub__(self, o):
        return self._binop(o, torch.sub)

    def __rsub__(self, o):
        return self._rbinop(o, torch.sub)

    def __mul__(self, o):
        return self._binop(o, torch.mul)

    def __rmul__(self, o):
        return self._rbinop(o, torch.mul)

    def __truediv__(self, o):
        return self._binop(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._rbinop(o, torch.true_divide)

    def __pow__(self, o):
        return self._binop(o, torch.pow)

    def __neg__(self):
        return Dense(-self.data)

    def __matmul__(self, o):
        return Dense(self.data @ unwrap(o))

    # comparisons give boolean containers (used by _while conditions)
    def __lt__(self, o):
        return self._binop(o, torch.lt)

    def __le__(self, o):
        return self._binop(o, torch.le)

    def __gt__(self, o):
        return self._binop(o, torch.gt)

    def __ge__(self, o):
        return self._binop(o, torch.ge)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Dense(shape={self.shape}, dtype={self.dtype}, " \
               f"device={self.device})"


def bind(host_array: Any, *, dtype: Any = None, device: Any = None) -> Dense:
    """Module-level ``bind`` mirroring the paper's free function."""
    return Dense.bind(host_array, dtype=dtype, device=device)
