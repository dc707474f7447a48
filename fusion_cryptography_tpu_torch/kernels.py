"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) at first use
into ``build/kernels/<hash>/`` and loaded with ctypes through a plain C
interface (no PyTorch headers, so a build takes seconds).  Only the wrappers
in ``ops/keccak_sponge.py`` and ``ops/intt_norm_weight.py`` call into the
library; each adds one to ``LAUNCHES[name]`` where it launches its kernel,
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from ._build import build_log, build_shared_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "keccak_sponge.cu", CSRC / "intt_norm_weight.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches since the last clear()
LAUNCHES: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _command(out: Path) -> list:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(out), *map(str, SOURCES),
    ]


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if nvcc fails)."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        path = build_shared_library("kernels", SOURCES, _command)
        lib = ctypes.CDLL(str(path))
        P, I32, I64, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
        lib.fct_keccak_absorb.argtypes = [P, P, P, I32, I64, P]
        lib.fct_keccak_absorb.restype = I32
        lib.fct_keccak_squeeze.argtypes = [P, P, I32, I64, P]
        lib.fct_keccak_squeeze.restype = I32
        lib.fct_intt_norm_weight.argtypes = [P, I64, I32, P, P, U32, U32, U32, P, P, P]
        lib.fct_intt_norm_weight.restype = I32
        _lib, _lib_path = lib, path
        return lib


def build_report() -> str:
    """nvcc's output for the loaded library (``-Xptxas -v`` register and
    spill report per kernel)."""
    return build_log(_lib_path) if _lib_path is not None else ""


def cuda_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
