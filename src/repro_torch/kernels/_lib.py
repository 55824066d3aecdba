"""Builds the CUDA sources in ``csrc/`` and binds them with ctypes.

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds them in seconds.  Each ``.cu`` compiles to an object in its
own ``nvcc`` process, all started together, and the objects link into one
shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib<hash>.so *.o

The library lands in ``kernels/_build/`` (ignored by git), named by a hash
of the sources and flags, so it is built at first use and again whenever a
source changes.  Every C entry point launches on the stream it is given,
allocates nothing and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core.registry import device_type_of

__all__ = ["lib", "check", "stream_of", "on_host", "require_cuda",
           "require_dtypes", "SOURCES", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("common.cu", "matmul.cu", "spmv.cu", "fft.cu", "spmm.cu",
           "spgemm.cu", "flash_attention.cu", "flash_attention_tiles.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry point -> argument types (pointers and the stream as c_void_p).
_SIGNATURES = {
    "matmul_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spmv_ell_launch": (_P, _P, _P, _P, _I, _I, _P),
    "spmv_dia_launch": (_P, _P, _P, _P, _I, _I, _P),
    "fft_stages_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P),
    "spmm_ell_launch": (_P, _P, _P, _P, _I, _I, _I, _P),
    "spmm_bsr_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "spgemm_bsr_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _I, _I, _P),
    "flash_attention_tiles_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _I, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *CFLAGS, "-c", str(CSRC / s),
                                   "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        failures = []
        for s, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                failures.append(f"{s}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        so = Path(tmp) / target.name
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(so),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(so, target)      # atomic: concurrent builds agree


@functools.cache
def lib() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    target = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if not target.exists():
        _build(target)
    handle = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.kernels_error_string.argtypes = (ctypes.c_int,)
    handle.kernels_error_string.restype = ctypes.c_char_p
    return handle


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib().kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_host(*tensors: torch.Tensor) -> bool:
    """True if no operand lies on a CUDA device (the registry's device
    rule): a kernel wrapper then computes its plain version."""
    return device_type_of(*tensors) == "cpu"


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the same CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def require_dtypes(what: str, floats, ints,
                   allowed=(torch.float32,)) -> None:
    """One dtype from ``allowed`` shared by every tensor in ``floats`` and
    int32 for every one in ``ints``, or raise: nothing is cast quietly.
    The sparse kernels allow f32 only; the attention kernels f32 or bf16
    (``cuda_bf16.h``)."""
    if any(t.dtype != floats[0].dtype for t in floats) \
            or floats[0].dtype not in allowed \
            or any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{what}: takes one of {list(allowed)} for values "
                         f"and int32 indices, got "
                         f"{[t.dtype for t in (*floats, *ints)]}")
