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
source changes.  Each compile runs with ``-Xptxas -v``; what ptxas says of
every kernel (registers, spill bytes) is kept beside the library and read
by :func:`ptxas_report`.  Every C entry point launches on the stream it is
given, allocates nothing and returns ``cudaGetLastError()``; :func:`check`
turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core.registry import device_type_of

__all__ = ["lib", "check", "stream_of", "on_host", "require_cuda",
           "require_dtypes", "ptxas_report", "split_scratch", "SOURCES",
           "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("common.cu", "matmul.cu", "spmv.cu", "fft.cu", "spmm.cu",
           "spgemm.cu", "flash_attention.cu", "flash_attention_tiles.cu",
           "flash_attention_lens.cu", "flash_attention_bwd.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C entry point -> argument types (pointers and the stream as c_void_p).
_SIGNATURES = {
    "matmul_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spmv_ell_launch": (_P, _P, _P, _P, _I, _I, _P),
    "spmv_dia_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    "fft_stages_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P),
    "spmm_ell_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P),
    "spmm_bsr_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P),
    "spgemm_bsr_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _I, _I, _P),
    "flash_attention_lens_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                    _I, _I, _I, _I, _P),
    "flash_attention_tiles_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _I, _I, _P),
    "fa_bwd_delta_launch": (_P, _P, _P, _L, _I, _I, _P),
    "fa_bwd_dkdv_launch": (_P,) * 17 + (_I,) * 12 + (_F, _I, _P),
    "fa_bwd_dq_launch": (_P,) * 13 + (_I,) * 12 + (_F, _I, _P),
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
        failures, logs = [], []
        for s, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                failures.append(f"{s}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        _ptxas_log(target).write_text("".join(logs))
        so = Path(tmp) / target.name
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(so),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(so, target)      # atomic: concurrent builds agree


def _ptxas_log(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def _target() -> Path:
    return BUILD_DIR / f"libreprotorch_{_digest()}.so"


def ptxas_report(names) -> dict:
    """What ptxas said of the built kernels whose (mangled) symbol holds
    one of ``names``: per name, how many instantiations there are and the
    largest register count and spill stores and loads (bytes) among them.
    Empty if the build kept no log."""
    log = _ptxas_log(_target())
    if not log.exists():
        return {}
    found, current = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(Compiling entry function|Function properties for)"
                      r" '?([\w$]+)", line)
        if m:
            current = next((n for n in names if n in m.group(2)), None)
            if current is not None and m.group(1).startswith("Compiling"):
                rec = found.setdefault(current, dict.fromkeys(
                    ("instantiations", "registers", "spill_stores",
                     "spill_loads"), 0))
                rec["instantiations"] += 1
            continue
        if current is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                found[current][key] = max(found[current][key],
                                          int(m.group(1)))
    return found


#: The error of a build that failed in this process, if one did.
_FAILED: list = []


@functools.cache
def lib() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once.  A build
    that failed is not tried again in the same process: later calls raise
    its error at once."""
    target = _target()
    if not target.exists():
        if _FAILED:
            raise RuntimeError(_FAILED[0])
        try:
            _build(target)
        except RuntimeError as exc:
            _FAILED.append(str(exc))
            raise
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


#: (device, stream) -> (partials, tickets): the scratch of the kernels that
#: split a sum over CTAs and let the last CTA of a group add the partials
#: (spmv_dia, flash_attention_lens), grown as needed.  Launches on one
#: stream run in order, so they may share it; the kernels leave the
#: tickets at 0.
_SPLIT_SCRATCH: dict = {}


def split_scratch(device, stream: int, nfloats: int, ntickets: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """At least ``nfloats`` f32 partials and ``ntickets`` int32 tickets
    (zero between launches) on ``device`` for launches on ``stream``."""
    key = (device, stream)
    part, tickets = _SPLIT_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < nfloats:
        part = torch.empty(nfloats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < ntickets:
        tickets = torch.zeros(ntickets, dtype=torch.int32, device=device)
    _SPLIT_SCRATCH[key] = (part, tickets)
    return part, tickets


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
