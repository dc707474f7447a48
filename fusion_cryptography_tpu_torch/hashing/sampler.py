"""Seeded samplers with CPython-``random`` bit-parity.

A copy of the JAX package's ``hashing/sampler.py`` (stdlib + numpy only),
so the port never imports that package.

The reference draws all randomness from CPython's global Mersenne Twister via
``random.seed`` / ``random.randrange`` (algebra/polynomials.py:447-459, :478-480),
and those exact streams are KAT-observable.  Because this framework also runs on
CPython, we use the same stdlib generator — no reimplementation needed — and
return dense numpy arrays instead of polynomial objects.

Quirk preserved (KAT-observable): when a matrix is sampled with an integer seed,
the reference re-seeds *per entry* (fusion/fusion.py:144-201 calls the sampler
once per matrix cell, each call re-seeding), so every entry of the matrix is the
identical polynomial.  ``seed=None`` draws entries sequentially from the running
global stream.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np


def sample_short_poly_coeffs(
    modulus: int,
    degree: int,
    norm_bound: int,
    weight_bound: int,
    seed: Optional[int],
) -> np.ndarray:
    """Sample a short polynomial: exactly min(degree, weight_bound) nonzero
    coefficients with values ±(1 + randrange(bound)), positions fixed by a full
    Fisher–Yates pass (exact semantics of algebra/polynomials.py:436-467).

    Returns int32[degree] raw sampled values (not reduced — they are already in
    range and serialize as-is).
    """
    if seed is not None:
        random.seed(seed)
    num = max(0, min(degree, weight_bound))
    bound = max(0, min(modulus // 2, norm_bound))
    coefs = [(1 + random.randrange(bound)) * (1 - 2 * random.randrange(2)) for _ in range(num)]
    coefs += [0] * (degree - len(coefs))
    if num < degree:
        for i in range(degree - 1, 0, -1):
            j = random.randrange(i + 1)
            coefs[i], coefs[j] = coefs[j], coefs[i]
    return np.array(coefs, dtype=np.int32)


def sample_uniform_ntt_values(modulus: int, degree: int, seed: Optional[int]) -> np.ndarray:
    """Uniform NTT-domain values ``randrange(modulus) - modulus//2`` (exact
    semantics of algebra/polynomials.py:470-488).  Returns int32[degree]."""
    if seed is not None:
        random.seed(seed)
    half = modulus // 2
    vals = [random.randrange(modulus) - half for _ in range(degree)]
    return np.array(vals, dtype=np.int32)


def sample_short_matrix_coeffs(
    modulus: int,
    degree: int,
    norm_bound: int,
    weight_bound: int,
    num_rows: int,
    num_cols: int,
    seed: Optional[int],
) -> np.ndarray:
    """Matrix of short polynomials as int32[num_rows, num_cols, degree],
    preserving the per-entry-reseed quirk for integer seeds (every entry equal)
    and sequential-stream draws for ``seed=None``."""
    if seed is not None:
        one = sample_short_poly_coeffs(modulus, degree, norm_bound, weight_bound, seed)
        return np.broadcast_to(one, (num_rows, num_cols, degree)).copy()
    entries = [
        sample_short_poly_coeffs(modulus, degree, norm_bound, weight_bound, None)
        for _ in range(num_rows * num_cols)
    ]
    return np.stack(entries).reshape(num_rows, num_cols, degree)
