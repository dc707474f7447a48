"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``) at first
use, all of them at once, into ``build/kernels_<source>/<hash>/`` (the hash
covers the source and the shared ``csrc/*.cuh`` headers), and loaded with
ctypes through a plain C interface (no PyTorch headers, so a build takes
seconds).  Only the wrappers in ``ops/keccak_sponge.py``, ``ops/ntt.py``,
``ops/intt_norm_weight.py``, ``ops/preimage_fold.py``, ``ops/assemble_spec.py``,
``ops/xof_decode.py``, ``ops/ragged_words.py`` (``render_bigint_dec_w``),
``ops/lattice_target.py``, ``ops/place_preimages.py`` and ``ops/sample_short.py``
call into the library; each adds one to ``LAUNCHES[name]`` where it launches
its kernel, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

import torch

from ._build import build_log, build_shared_library

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I32, _I64, _U32, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                               ctypes.c_uint64)
# source -> its C entry points and their argtypes; every entry point returns
# cudaGetLastError()
SOURCES = {
    "keccak_sponge.cu": {
        "fct_keccak_absorb": [_P, _P, _P, _I32, _I64, _I32, _P],
        "fct_keccak_squeeze": [_P, _P, _I32, _I64, _I32, _P],
    },
    "intt_norm_weight.cu": {
        "fct_intt_norm_weight": [_P, _I64, _I32, _I32, _P, _P, _P, _P, _U32, _U32, _U32,
                                 _P, _P, _P, _P],
    },
    "ntt.cu": {
        "fct_ntt_u": [_P, _P, _I64, _I32, _P, _P, _I32, _U32, _U32, _U32, _P],
        "fct_ntt_centered": [_P, _P, _I64, _I32, _P, _P, _I32, _U32, _U32, _U32, _P],
    },
    "preimage_fold.cu": {
        "fct_signer_fold_a": [_P, _I32, _P, _P, _P, _I32, _P, _I64, _P, _I32, _P, _P, _I32,
                              _P, _P],
        "fct_signer_fold_b": [_P, _I32, _P, _P, _I32, _P, _P, _I32, _P, _P, _I64, _P, _I32,
                              _P, _P],
        "fct_agg_fold": [_P, _I32, _P, _P, _P, _I32, _I64, _I64, _I64, _I64, _I64, _I32, _I64,
                         _P, _I32, _P, _P, _P, _P],
    },
    "assemble_spec.cu": {
        "fct_assemble_spec": [_P, _I32, _P, _P, _I64, _P, _I64, _P, _I32, _P, _P],
    },
    "xof_decode.cu": {
        "fct_xof_decode": [_P, _I64, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _U32, _P,
                           _I32, _P, _P],
        "fct_xof_decode_shape": [_I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _U32, _I32, _P],
    },
    "render_prehash.cu": {
        "fct_render_prehash": [_P, _I64, _P, _P, _P],
        "fct_render_prehash_shape": [_I64, _P],
    },
    "lattice_target.cu": {
        "fct_lattice_target": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _U32, _U64, _I64,
                               _I64, _P, _P, _P, _I32, _P, _P],
    },
    "place_preimages.cu": {
        "fct_place_preimages": [_P, _I32, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P],
    },
    "sample_short.cu": {
        "fct_sample_short": [_P, _I64, _P, _I32, _I32, _I32, _I64, _P, _P],
    },
}

# kernel name -> launches since the last clear()
LAUNCHES: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None
_lib_paths: List[Path] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _command(src: Path):
    def command(out: Path) -> list:
        return [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src),
        ]
    return command


def _build(name: str) -> Path:
    src = CSRC / name
    return build_shared_library(f"kernels_{src.stem}", [src, *sorted(CSRC.glob("*.cuh"))],
                                _command(src))


def library() -> SimpleNamespace:
    """Every entry point of ``SOURCES``, built on first call: one nvcc per
    source, all started together (raises if a build fails)."""
    global _lib, _lib_paths
    with _lock:
        if _lib is not None:
            return _lib
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            paths = list(pool.map(_build, SOURCES))
        fns = {}
        for path, entries in zip(paths, SOURCES.values()):
            dll = ctypes.CDLL(str(path))
            for name, argtypes in entries.items():
                fn = getattr(dll, name)
                fn.argtypes, fn.restype = argtypes, _I32
                fns[name] = fn
        _lib, _lib_paths = SimpleNamespace(**fns), paths
        return _lib


def build_report() -> str:
    """nvcc's output for the loaded libraries (``-Xptxas -v`` register and
    spill report per kernel)."""
    return "".join(build_log(p) for p in _lib_paths)


def cuda_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


SHAPE_KEYS = ("blocks", "threads", "smem_bytes", "registers", "blocks_per_sm")


def launch_shape(entry: str, *args) -> dict:
    """The launch a ``*_shape`` entry point describes (it launches nothing):
    blocks, threads a block, dynamic shared memory bytes, registers a
    thread, blocks an SM can hold, and waves = blocks / (blocks an SM x
    the card's SMs)."""
    info = (ctypes.c_int32 * len(SHAPE_KEYS))()
    check_launch(getattr(library(), entry)(*args, info), entry)
    shape = dict(zip(SHAPE_KEYS, info))
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    shape["waves"] = shape["blocks"] / max(1, shape["blocks_per_sm"] * sms)
    return shape


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")


def outputs(outs, shapes, device, dtype: torch.dtype = torch.int32) -> list:
    """A kernel's outputs of ``dtype``: ``outs`` (a caller's tensors, for
    example pre-filled ones) checked against ``shapes`` on ``device``, or new
    tensors of those shapes when ``outs`` is None."""
    if outs is None:
        return [torch.empty(shape, dtype=dtype, device=device) for shape in shapes]
    for t, shape in zip(outs, shapes):
        require_cuda_tensor(t, "out", dtype, len(shape))
        if tuple(t.shape) != tuple(shape) or t.device != device:
            raise ValueError(f"out: expected {dtype}{list(shape)} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return list(outs)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary: the kernels read and write rows as 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
