"""List-level NTT API mirroring the reference ``algebra/ntt.py`` surface.

The port of the JAX package's ``algebra/ntt.py``: the same function names,
argument names, list-in/list-out conventions and validation errors as the
reference kernel layer (algebra/ntt.py:17-484), over the port's batched
transforms (ops/ntt.py).  The transforms run on ``device`` (the card unless
``device="cpu"``): there the NTT kernels, whose degrees are the powers of
two from 64 to 1024.

The dead ``ntt_poly_mult_half`` (reference ntt.py:487-596) is intentionally
not provided: it is unused and crashes if called.
"""
from __future__ import annotations

from typing import List

import torch

from ..ops import numtheory as _nt
from ..ops.ntt import make_plan, negacyclic_poly_mult, ntt_fwd, ntt_inv
from ..ops.numtheory import (  # re-exports (API parity)
    bit_reverse_copy,
    find_primitive_root,
    has_primitive_root_of_unity,
    is_odd_prime,
    is_pow_two_geq_two,
    is_primitive_root,
    is_root_of_unity,
)
from ..ops.upload import resolve_device

__all__ = [
    "is_odd_prime",
    "has_primitive_root_of_unity",
    "is_pow_two_geq_two",
    "bit_reverse_copy",
    "cent",
    "is_root_of_unity",
    "is_primitive_root",
    "find_primitive_root",
    "cooley_tukey_ntt",
    "gentleman_sande_intt",
    "ntt_poly_mult",
]


def cent(val: int, modulus: int, halfmod: int, logmod: int) -> int:
    """Scalar centered reduction (reference ntt.py:93-123 contract, including
    its argument validation)."""
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in (val, modulus, halfmod, logmod)):
        raise TypeError("Input must be integers")
    if modulus < 2:
        raise ValueError("Modulus must be at least 2")
    if halfmod < 1:
        raise ValueError("Halfmod must be at least 1")
    if logmod < 1:
        raise ValueError("Logmod must be at least 1")
    return _nt.cent_int(val, modulus)


def _validate_transform_args(val, modulus, root_order, powers, powers_name):
    if not isinstance(val, list):
        raise TypeError(f"val must be a list, but got {type(val)}")
    if not isinstance(modulus, int):
        raise TypeError(f"modulus must be an int, but got {type(modulus)}")
    if not isinstance(powers, list):
        raise TypeError(f"{powers_name} must be a list, but got {type(powers)}")
    if not all(isinstance(v, int) for v in powers):
        raise TypeError(f"{powers_name} must be a list of ints, but got {type(powers)}")
    if not isinstance(root_order, int):
        raise TypeError(f"root_order must be an int, but got {type(root_order)}")
    if not all(isinstance(v, int) for v in val):
        raise TypeError(f"val must be a list of ints, but got {type(val)}")
    if not is_odd_prime(modulus):
        raise ValueError(f"modulus={modulus} must be an odd prime")
    if not has_primitive_root_of_unity(modulus, root_order):
        raise ValueError(
            f"modulus={modulus} does not have a primitive root of order root_order={root_order}"
        )
    if not is_pow_two_geq_two(len(val)):
        raise ValueError(f"len(val)={len(val)} must be a power of 2 greater than 1")
    if root_order != 2 * len(val) and root_order != len(val):
        raise ValueError(
            f"root_order={root_order} must be degree or twice the degree, {len(val)}"
        )
    if root_order == len(val):
        raise NotImplementedError(
            f"root_order={root_order}=degree={len(val)} is not implemented"
        )


def _root_from_brp(bit_rev_root_powers: List[int], modulus: int) -> int:
    """The twiddle table is bitrev([psi^0..psi^(d-1)]); psi itself sits at the
    bit-reversed position of index 1, which is d/2 for any power-of-two d."""
    d = len(bit_rev_root_powers)
    return bit_rev_root_powers[d // 2] % modulus if d > 1 else 1


def _centered(vals: List[int], modulus: int, device) -> torch.Tensor:
    return torch.tensor([_nt.cent_int(v, modulus) for v in vals], dtype=torch.int32,
                        device=resolve_device(device))


def cooley_tukey_ntt(
    val: List[int], modulus: int, root_order: int, bit_rev_root_powers: List[int], *,
    device=None,
) -> List[int]:
    """Forward negacyclic NTT, standard order in -> bit-reversed out (reference
    ntt.py:216-291 semantics, in-place: ``val`` is mutated and returned)."""
    _validate_transform_args(val, modulus, root_order, bit_rev_root_powers, "root_powers")
    root = _root_from_brp(bit_rev_root_powers, modulus)
    plan = make_plan(modulus, len(val), root)
    val[:] = ntt_fwd(plan, _centered(val, modulus, device)).tolist()
    return val


def gentleman_sande_intt(
    val: List[int], modulus: int, root_order: int, bit_rev_inv_root_powers: List[int], *,
    device=None,
) -> List[int]:
    """Inverse negacyclic NTT, bit-reversed order in -> standard out (reference
    ntt.py:294-377 semantics, in-place)."""
    _validate_transform_args(val, modulus, root_order, bit_rev_inv_root_powers, "inv_root_powers")
    inv_root = _root_from_brp(bit_rev_inv_root_powers, modulus)
    root = pow(inv_root, modulus - 2, modulus)
    plan = make_plan(modulus, len(val), root)
    val[:] = ntt_inv(plan, _centered(val, modulus, device)).tolist()
    return val


def ntt_poly_mult(
    f: List[int], g: List[int], modulus: int, root: int, inv_root: int, root_order: int, *,
    device=None,
) -> List[int]:
    """INTT(NTT(f) * NTT(g)) with the reference's argument validation AND its
    in-place side effect of transforming f and g forward then back (reference
    ntt.py:380-484 — the round trip leaves them centered)."""
    if (
        not isinstance(f, list)
        or not isinstance(g, list)
        or not isinstance(modulus, int)
        or not isinstance(root, int)
        or not isinstance(inv_root, int)
        or not isinstance(root_order, int)
    ):
        raise ValueError(
            "Input f and g must be lists of integers, input modulus must be "
            "integer, and input root and inv_root must be integer."
        )
    if not is_odd_prime(modulus):
        raise ValueError("Modulus must be an odd prime.")
    if not is_pow_two_geq_two(root_order):
        raise ValueError("Root order must be a power of two greater than or equal to 2.")
    if not len(f) == len(g) == root_order // 2:
        raise ValueError(
            f"f and g must be coefficient representation of degree root_order//2 - 1 "
            f"polynomial, but had len(f)={len(f)}, len(g)={len(g)}"
        )
    if not has_primitive_root_of_unity(modulus, root_order):
        raise ValueError("Modulus does not have a primitive root of unity of order root_order.")
    if not is_primitive_root(root, modulus, root_order):
        raise ValueError("Input root must be a primitive root of unity.")
    if (root * inv_root) % modulus != 1:
        raise ValueError("Input inv_root must be the inverse of the root of unity.")
    plan = make_plan(modulus, len(f), root)
    fa = _centered(f, modulus, device)
    ga = _centered(g, modulus, device)
    out = negacyclic_poly_mult(plan, fa, ga)
    # side-effect parity: the reference leaves f and g NTT'd-then-inverted,
    # i.e. centered representatives of their residues
    f[:] = fa.tolist()
    g[:] = ga.tolist()
    return out.tolist()
