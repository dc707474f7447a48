"""Host-side number theory: primality, roots of unity, primitive-root search.

A copy of the JAX package's ``ops/numtheory.py`` (pure Python, no tensors), so
the port never imports that package.  Feature-parity with the predicate layer
of the reference (algebra/ntt.py:17-213): deterministic Miller–Rabin instead of
trial division, and ``functools.lru_cache`` instead of module-level dicts.
These run on the host at plan-build time only.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

# Witnesses proving primality for every n < 3,317,044,064,679,887,385,961,981.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


@lru_cache(maxsize=None)
def is_odd_prime(val) -> bool:
    """True iff ``val`` is an odd prime (deterministic Miller–Rabin).

    Mirrors the contract of reference algebra/ntt.py:17 (including rejecting
    non-int inputs by returning False rather than raising).
    """
    if not isinstance(val, int) or isinstance(val, bool) or val < 3 or val % 2 == 0:
        return False
    d, r = val - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        if a % val == 0:
            continue
        x = pow(a, d, val)
        if x in (1, val - 1):
            continue
        for _ in range(r - 1):
            x = x * x % val
            if x == val - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def has_primitive_root_of_unity(modulus, root_order) -> bool:
    """True iff Z_modulus* can contain an element of order ``root_order``
    (parity with reference algebra/ntt.py:36: just the divisibility test)."""
    if not isinstance(modulus, int) or not isinstance(root_order, int):
        return False
    if modulus < 3 or root_order < 2:
        return False
    return (modulus - 1) % root_order == 0


@lru_cache(maxsize=None)
def is_pow_two_geq_two(val) -> bool:
    """True iff ``val`` is a power of two, at least 2 (reference algebra/ntt.py:59)."""
    return isinstance(val, int) and not isinstance(val, bool) and val >= 2 and (val & (val - 1)) == 0


@lru_cache(maxsize=None)
def is_root_of_unity(val, modulus, root_order) -> bool:
    """val**root_order == 1 mod modulus (reference algebra/ntt.py:126)."""
    if not all(isinstance(x, int) for x in (val, modulus, root_order)):
        return False
    if modulus < 2 or root_order < 1:
        return False
    return pow(val, root_order, modulus) == 1


@lru_cache(maxsize=None)
def is_primitive_root(val, modulus, root_order) -> bool:
    """True iff ``val`` has exact multiplicative order ``root_order`` mod modulus.

    The reference checks all proper powers (algebra/ntt.py:177-179, O(root_order)
    modexps — its dominant hidden cost when re-validated per polynomial object);
    it suffices to check the maximal proper divisors root_order/p for each prime
    p | root_order, which is what we do.
    """
    if not all(isinstance(x, int) for x in (val, modulus, root_order)):
        return False
    if modulus < 2 or root_order < 1:
        return False
    if pow(val, root_order, modulus) != 1:
        return False
    for p in _prime_factors(root_order):
        if pow(val, root_order // p, modulus) == 1:
            return False
    return True


@lru_cache(maxsize=None)
def _prime_factors(n: int) -> tuple:
    out: List[int] = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return tuple(out)


@lru_cache(maxsize=None)
def find_primitive_root(modulus, root_order) -> Optional[int]:
    """Smallest primitive root of order ``root_order`` mod ``modulus``, or None
    (reference algebra/ntt.py:184: same smallest-first search order, so results
    agree wherever the reference succeeds)."""
    if not isinstance(modulus, int) or not isinstance(root_order, int):
        return None
    if modulus < 2 or root_order < 1:
        return None
    if not has_primitive_root_of_unity(modulus, root_order):
        return None
    for r in range(2, modulus):
        if is_primitive_root(r, modulus, root_order):
            return r
    raise RuntimeError(
        f"No primitive root found with modulus={modulus}, root_order={root_order}."
    )


def bit_reverse_indices(n: int) -> List[int]:
    """The bit-reversal permutation of range(n), n a power of two — the index map
    behind the reference's ``bit_reverse_copy`` (algebra/ntt.py:74)."""
    k = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        b = 0
        x = i
        for _ in range(k):
            b = (b << 1) | (x & 1)
            x >>= 1
        out[i] = b
    return out


def bit_reverse_copy(val: list) -> list:
    """Permute a list by bit-reversed index (API parity with algebra/ntt.py:74)."""
    if not isinstance(val, list):
        raise ValueError("Input must be a list")
    idx = bit_reverse_indices(len(val))
    return [val[i] for i in idx]


def cent_int(val: int, modulus: int) -> int:
    """Host-side scalar centered reduction (exact behavior of algebra/ntt.py:93,
    which maps any int to the representative in [-(modulus//2), modulus//2])."""
    y = val % modulus
    return y - modulus if y > modulus // 2 else y
