"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file,
all of them at once, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lives in
``build/repro_torch/`` at the root of the checkout, named by a digest of
the sources and flags, so a changed source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built when a module is imported: the
first kernel launch builds, or a caller (``chip_smoke.py``) calls
``build()`` first to time it.

Launch counts: every kernel wrapper adds one to ``launches[name]`` where
it launches its kernel and nowhere else, so a run can show which kernels
its main path went through.  Like the loaded library, the counts belong
to the process.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# storage-type codes understood by the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "flash_attention": 0,
            "flash_decode": 0, "ssd_chunk": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, scale, y, n, d, eps, dtype, path, stream
    "repro_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    # x, scale, g, dx, part, n, d, rows_per_block, eps, dtype, vec, stream
    "repro_rmsnorm_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, logit_cap, dtype, vec,
    # stream
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _I, _P],
    # q, k, v, lengths, out, scratch, B, S, H, KVH, hd, split_keys,
    # logit_cap, dtype, vec, stream
    "repro_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _I, _I, _P],
    # x, b, c, dt, a_log, y, states, decay, work, B, Q, nh, hp, ds,
    # head_block, dtype, dt_dtype, vec, stream
    "repro_ssd_chunk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    # Q -> work-space floats per (chunk, head)
    "repro_ssd_chunk_scratch": [_I],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    commands: list[list[str]]       # empty when the library was already built
    seconds: float


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile and link the kernel library unless it is already built."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libreprotorch_kernels_{tag}.so"
    if out.exists():
        return BuildInfo(out, [], 0.0)
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [work / (src.stem + ".o") for src in sources]
    commands = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    errors = []
    for cmd, proc in zip(commands, procs):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{text}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = work / out.name
    link = [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                           f"{res.stdout}")
    os.replace(tmp, out)            # atomic: a reader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return BuildInfo(out, [*commands, link], time.perf_counter() - t0)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build().path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
                handle.repro_cuda_error_string.restype = ctypes.c_char_p
                _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        text = lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({text})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream, for a tensor on the current
    device (the kernels launch there)."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")
