"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ctypes. The library lands in
``build/hyvideo_prfl_torch/`` under the repository root, named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads the library already there. Nothing here runs at import time:
the first kernel launch builds.

Each C entry point takes device pointers, sizes and the CUDA stream, and
returns the ``cudaError_t`` of its launch; ``check`` raises on anything
but 0. ``LAUNCHES`` counts successful launches per kernel so a run can
show its main path went through them: the tracer's counters
``launch.<kernel>`` (utils/tracing.py), read by kernel name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from hyvideo_prfl_torch.utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyvideo_prfl_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = tracing.Counts("launch.")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/*.cu)
_SIGNATURES = {
    "hyv_ln_scale_shift": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "hyv_rmsnorm_rope": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "hyv_flash_fwd": [_P] * 6 + [_I] * 4 + [_LL] * 12 + [_F, _I, _I, _P],
    "hyv_ln_scale_shift_bwd": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 6 + [_P],
    "hyv_rmsnorm_rope_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "hyv_flash_bwd": [_P] * 14 + [_I] * 6 + [_LL] * 21 + [_F, _F, _P],
    "hyv_flash_bwd_merged": [_P] * 13 + [_I] * 5 + [_LL] * 21 + [_F, _F, _P],
    "hyv_flash_fwd_qk8": [_P] * 6 + [_I] * 4 + [_LL] * 12 + [_P],
    "hyv_rmsnorm_rope_bwd_parts": [_I] * 4,
    "hyv_probe_rate": [_P, _P, _P] + [_I] * 6 + [_P],
    "hyv_probe_chain": [_P, _P, _P] + [_I] * 5 + [_P],
    "hyv_probe_cluster": [_I] * 5,
    "hyv_rope": [_P] * 4 + [_LL, _I, _I, _I, _P],
    "hyv_flash_fwd_smem": [],
    "hyv_flash_bwd_merged_smem": [],
    "hyv_flash_bwd_dq_smem": [],
    "hyv_flash_fwd_qk8_smem": [],
}

_lib = None
build_seconds = None  # wall time of the build that produced the loaded lib
build_log = ""        # nvcc's output (ptxas register / spill report)


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    for cand in cands + [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one nvcc
    per source, all at once, then one link."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libhyv_kernels_{_digest()}.so"
    if out.exists():
        build_seconds = 0.0
        log = out.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = BUILD_DIR / f"{tag}.so"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                               "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.hyv_error_string.argtypes = [_I]
        handle.hyv_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a refused or failed launch; count it otherwise."""
    if err != 0:
        msg = lib().hyv_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
    tracing.count("launch." + name)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def plain(*tensors) -> None:
    """Raise TypeError on a DTensor: a kernel takes raw pointers to local
    memory, and FSDP2 hands a wrapped module's forward plain tensors, so a
    DTensor here is a sharded parameter that escaped its unshard."""
    import torch.distributed as dist

    if not dist.is_available():
        return
    from hyvideo_prfl_torch.parallel.sharding import is_dtensor

    for t in tensors:
        if is_dtensor(t):
            raise TypeError("a kernel was handed a DTensor; pass its local tensor")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def aligned16(*tensors) -> bool:
    """True when every tensor starts on a 16-byte boundary (the kernels
    load 16 bytes per lane)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
