"""Build and load the package's CUDA kernels.

The sources under ``pycsou_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one process per source in parallel, and linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The build runs
on first use, into ``build/pycsou_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources: an edited kernel is rebuilt, an unchanged
one is loaded.  Nothing here runs at import time.

Every failure raises: a missing ``nvcc``, a compile error, a refused launch.
No caller falls back to the plain PyTorch versions on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["TILE", "library", "check", "stream_of", "build_dir"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
TILE = 32  # output tile edge of every kernel (csrc/sepconv.cuh kTile)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of csrc/*.cu's extern "C" launchers (all return cudaError_t)
_SIGNATURES = {
    "pct_sepconv2d": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P],
    "pct_sepgram2d": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "pct_tv_sweep_stats": [_P] * 9 + [_I, _I, _F, _F, _F, _F, _I, _I, _P],
    "pct_tv_sweepm_stats": [_P] * 10 + [_I, _I, _F, _F, _F, _F, _I, _I, _P],
    "pct_tv_sweepm2": [_P] * 10 + [_I, _I, _F, _F, _F, _F, _I, _I, _P],
    "pct_tv_megar": [_P] * 10 + [_I, _I, _P] + [_I] * 7 + [_F] * 5 + [_I, _I, _P],
}


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_dir() -> Path:
    """``build/pycsou_tpu_torch/<source hash>`` next to the package."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(_ARCH.encode())
    return _PKG.parent / "build" / "pycsou_tpu_torch" / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of pycsou_tpu_torch are built from source on first use"
    )


def _compile(out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, _ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_suffix(f".{tag}.tmp")
    if not failed:
        link = subprocess.run([nvcc, _ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    (out.parent / "nvcc.log").write_text("".join(logs))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed building {out.name}:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first call, then cached)."""
    so = build_dir() / "libpycsou_kernels.so"
    if not so.is_file():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize`` would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
