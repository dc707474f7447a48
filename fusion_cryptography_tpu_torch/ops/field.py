"""Modular arithmetic over Z_q (q < 2**31 odd prime) on int64 torch tensors.

Port of the JAX package's ``ops/field.py``.  Residues are carried as int64 in
``[0, q)``: a product of two values below 2**31 is below 2**62, so every
product is exact and one ``%`` reduces it.  The TPU's 16-bit-limb widening
multiply is not needed on a GPU.  Outputs equal the JAX functions' for every
input in their domain:

* ``mont_mul(a, b)`` is ``a * b * 2**-32 mod q`` (the JAX REDC result, which
  is canonical for any a, b < 2**31), so ``mont_mul(to_mont(a), b)`` is the
  plain product ``a * b mod q``;
* ``sum_mod`` / ``dot_mod`` reduce each product before the sum, so a sum of n
  terms stays below n * q, exact in int64 for any realistic n.

Centered values (the public representation, ``[-(q//2), q//2]``) are int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

_I64 = torch.int64

# The Fusion prime (fusion/fusion.py:17): q - 1 = 2**9 * 4194269.
Q: int = 2147465729
HALF_Q: int = Q // 2


@dataclass(frozen=True)
class Field:
    """Constants and primitive ops for one odd prime modulus q < 2**31."""

    q: int

    def __post_init__(self):
        if not (3 <= self.q < (1 << 31)) or self.q % 2 == 0:
            raise ValueError(f"modulus must be an odd prime below 2**31, got {self.q}")

    @property
    def half(self) -> int:
        return self.q // 2

    @property
    def r_mod_q(self) -> int:
        return (1 << 32) % self.q

    @property
    def r_inv(self) -> int:
        """2**-32 mod q: the Montgomery factor of ``mont_mul``."""
        return pow(1 << 32, -1, self.q)

    def shoup(self, s: int) -> int:
        """floor(s * 2**32 / q): the Shoup companion word of constant ``s``
        (used by the CUDA INTT kernel's butterflies)."""
        return (s << 32) // self.q

    # ---- representation changes ------------------------------------------
    def to_unsigned(self, x: torch.Tensor) -> torch.Tensor:
        """Centered representative -> residue in [0, q) (int64)."""
        x = x.to(_I64)
        return torch.where(x < 0, x + self.q, x)

    def to_centered(self, u: torch.Tensor) -> torch.Tensor:
        """Residue in [0, q) -> centered int32 representative (the range
        contract of the reference's ``cent``)."""
        u = u.to(_I64)
        return torch.where(u > self.half, u - self.q, u).to(torch.int32)

    # ---- ring ops on residues --------------------------------------------
    def add_mod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a + b
        return torch.where(s >= self.q, s - self.q, s)

    def sub_mod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(a >= b, a - b, a + (self.q - b))

    def mont_mul(self, a: torch.Tensor, b) -> torch.Tensor:
        """``a * b * 2**-32 mod q``; with one operand lifted by
        :meth:`to_mont` this is the plain modular product."""
        return ((a * b) % self.q) * self.r_inv % self.q

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return (a * self.r_mod_q) % self.q

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return (a * self.r_inv) % self.q

    # ---- long reductions -------------------------------------------------
    def sum_mod(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Modular sum of residues along ``axis`` (the reference's
        cent-per-add aggregation loops, fusion/fusion.py:670-677)."""
        return x.sum(dim=axis) % self.q

    def dot_mod(self, a_mont: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
        """sum_k a_mont[k] * b[k] mod q along ``axis`` with ``a_mont``
        pre-lifted: each product is reduced before the sum (int64 headroom)."""
        return self.sum_mod(self.mont_mul(a_mont, b), axis=axis)


@lru_cache(maxsize=None)
def get_field(q: int) -> Field:
    return Field(q)


FUSION_FIELD = get_field(Q)

to_unsigned = FUSION_FIELD.to_unsigned
to_centered = FUSION_FIELD.to_centered
add_mod = FUSION_FIELD.add_mod
sub_mod = FUSION_FIELD.sub_mod
mont_mul = FUSION_FIELD.mont_mul
to_mont = FUSION_FIELD.to_mont
from_mont = FUSION_FIELD.from_mont
sum_mod = FUSION_FIELD.sum_mod
dot_mod = FUSION_FIELD.dot_mod
