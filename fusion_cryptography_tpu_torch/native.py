"""ctypes binding for the host sampler of ``native/fusion_native.c``.

The port reuses the repository's C source (CPython-exact MT19937 streams, so
sampled keys match the reference bit for bit) but builds it into its own
gitignored directory (``build/fusion_native/``), never next to the source.  Only the
batched short-polynomial sampler is bound: the fleet build samples 2·G·N
polynomials, which the pure-Python ``random`` fallback
(hashing/sampler.py) cannot do at fleet scale.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ._build import REPO_ROOT, build_shared_library

_SRC = REPO_ROOT / "native" / "fusion_native.c"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists() or shutil.which("gcc") is None:
            return None
        path = build_shared_library(
            "fusion_native",
            [_SRC],
            lambda out: ["gcc", "-O3", "-shared", "-fPIC", "-pthread",
                         "-o", str(out), str(_SRC)],
            timeout_s=120.0,
        )
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fn_sample_short_batch.argtypes = [
            u64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, i32p,
        ]
        lib.fn_sample_short_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the C sampler could be built and loaded (needs ``gcc``)."""
    return _load() is not None


def sample_short_batch(seeds: Sequence[int], degree: int, norm_bound: int,
                       weight_bound: int, modulus: int) -> np.ndarray:
    """One short polynomial per seed -> int32[len(seeds), degree], identical
    to ``hashing.sampler.sample_short_poly_coeffs`` seed by seed."""
    if max(0, min(degree, weight_bound)) > 0 and max(0, min(modulus // 2, norm_bound)) < 1:
        raise ValueError("empty range for randrange() (0, 0, 0)")
    lib = _load()
    if lib is None:
        raise RuntimeError("native sampler unavailable (no gcc or no source)")
    s = np.asarray(list(seeds), dtype=np.uint64)
    out = np.empty((len(s), degree), dtype=np.int32)

    def run(lo: int, hi: int) -> None:
        lib.fn_sample_short_batch(
            s[lo:hi].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), hi - lo,
            degree, norm_bound, weight_bound, modulus,
            out[lo:hi].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    # ctypes drops the GIL for the call and per-seed MT19937 seeding dominates,
    # so large batches split over host threads (disjoint output slices)
    n_threads = min(os.cpu_count() or 1, max(1, len(s) // 2048))
    if n_threads > 1:
        step = -(-len(s) // n_threads)
        with ThreadPoolExecutor(n_threads) as ex:
            futures = [ex.submit(run, lo, min(lo + step, len(s)))
                       for lo in range(0, len(s), step)]
            for f in futures:
                f.result()
    else:
        run(0, len(s))
    return out
