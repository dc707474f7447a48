"""Fusion parameter sets and the Params object (port of the JAX package's
``params.py``, reference fusion/fusion.py:16-295).

The values are derived from the scheme's formulas exactly as in the JAX
package, including the reference quirk that the runtime rejection bounds
``beta_ch``/``beta_ag`` are 1 at both security levels.  ``public_challenge``
stays a host numpy array (int32[rank, degree], centered NTT values); device
copies are made by the pipelines that need them, for the device they run on.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from math import ceil, log2
from typing import Any, Dict, Mapping, Optional

import numpy as np

from .ops.field import Q
from .ops.ntt import NTTPlan, make_plan

PRIME: int = Q

# Per-security-level scheme constants (reference fusion/fusion.py:17-37).
_LEVELS: Dict[int, Dict[str, int]] = {
    128: dict(
        degree=64,
        rank=195,
        capacity=1796,
        omega_ch=27,
        omega_ag=35,
        beta_sk=52,
        ch_bd=3,
        ag_bd=2,
        root=23584283,
    ),
    256: dict(
        degree=256,
        rank=83,
        capacity=2818,
        omega_ch=60,
        omega_ag=60,
        beta_sk=52,
        ch_bd=1,
        ag_bd=1,
        root=3337519,
    ),
}


def _dst(level_tag: int, phase: int) -> bytes:
    """Two-byte domain separation tag (level id, phase id) (fusion.py:38-55)."""
    return bytes([level_tag, phase])


def _xof_coef_bytes(secpar: int, beta: int) -> int:
    """Bytes of XOF output consumed per bounded coefficient (fusion.py:123-137)."""
    return ceil(ceil(log2(2 * beta + 1) / 8) + secpar / 8)


def _xof_shuffle_bytes(secpar: int, degree: int) -> int:
    """Bytes reserved for the Fisher–Yates index stream (fusion.py:138-141)."""
    return degree * ceil(ceil(log2(degree) / 8) + secpar / 8)


@dataclass(frozen=True, eq=False)
class Params:
    """Frozen Fusion parameter set + sampled public challenge."""

    secpar: int
    capacity: int
    modulus: int
    degree: int
    root_order: int
    root: int
    inv_root: int
    rank: int
    beta_sk: int
    beta_ch: int
    beta_ag: int
    beta_vf: int
    omega_sk: int
    omega_ch: int
    omega_ag: int
    omega_vf: int
    sign_pre_hash_dst: bytes
    sign_hash_dst: bytes
    agg_xof_dst: bytes
    bytes_for_one_coef_bdd_by_beta_ch: int
    bytes_for_one_coef_bdd_by_beta_ag: int
    bytes_for_poly_shuffle: int
    seed: Optional[int]
    public_challenge: np.ndarray  # int32 [rank, degree], centered NTT values

    num_rows_pub_challenge: int = 1
    num_rows_vk: int = 1
    num_cols_sk: int = 1
    num_cols_vk: int = 1

    @property
    def num_rows_sk(self) -> int:
        return self.rank

    @property
    def num_cols_pub_challenge(self) -> int:
        return self.rank

    @property
    def plan(self) -> NTTPlan:
        return make_plan(self.modulus, self.degree, self.root)

    def __str__(self) -> str:
        # the reference's Params repr (fusion.py:284-285): the KAT corpus
        # hashes and stores this string, so it is part of the wire format
        from .interop.serial import params_str

        return params_str(self)

    __repr__ = __str__

    def __eq__(self, other):
        if not isinstance(other, Params):
            return NotImplemented
        return self.secpar == other.secpar and np.array_equal(
            self.public_challenge, other.public_challenge
        )

    def __hash__(self):
        return hash((self.secpar, self.public_challenge.tobytes()))


def fusion_setup(secpar: int, seed: Optional[int]) -> Params:
    """Build the parameter set and sample the public challenge (fusion.py:294).

    An integer seed re-seeds CPython's Mersenne Twister per matrix entry in
    the reference (polynomials.py:478-479), so all ``rank`` entries are the
    same polynomial; ``seed=None`` draws every entry from the running stream.
    """
    if secpar not in _LEVELS:
        raise ValueError(f"unsupported security parameter {secpar}; choose 128 or 256")
    c = _LEVELS[secpar]
    degree, rank = c["degree"], c["rank"]
    root = c["root"]
    inv_root = pow(root, PRIME - 2, PRIME)
    level_tag = 1 if secpar == 128 else 3

    beta_vf_inter = c["beta_sk"] * (1 + min(degree, c["omega_ch"]) * c["ch_bd"])
    beta_vf = c["capacity"] * min(degree, c["omega_ag"]) * c["ag_bd"] * beta_vf_inter

    from .hashing.sampler import sample_uniform_ntt_values

    if seed is None:
        rows = [sample_uniform_ntt_values(PRIME, degree, None) for _ in range(rank)]
        pub = np.stack(rows).astype(np.int32)
    else:
        one = sample_uniform_ntt_values(PRIME, degree, seed)
        pub = np.broadcast_to(one, (rank, degree)).copy().astype(np.int32)

    return Params(
        secpar=secpar,
        capacity=c["capacity"],
        modulus=PRIME,
        degree=degree,
        root_order=2 * degree,
        root=root,
        inv_root=inv_root,
        rank=rank,
        beta_sk=c["beta_sk"],
        beta_ch=1,  # runtime bound quirk, see module docstring
        beta_ag=1,
        beta_vf=beta_vf,
        omega_sk=degree,
        omega_ch=c["omega_ch"],
        omega_ag=c["omega_ag"],
        omega_vf=degree,
        sign_pre_hash_dst=_dst(level_tag, 0),
        sign_hash_dst=_dst(level_tag, 1),
        agg_xof_dst=_dst(level_tag, 2),
        bytes_for_one_coef_bdd_by_beta_ch=_xof_coef_bytes(secpar, 1),
        bytes_for_one_coef_bdd_by_beta_ag=_xof_coef_bytes(secpar, 1),
        bytes_for_poly_shuffle=_xof_shuffle_bytes(secpar, degree),
        seed=seed,
        public_challenge=pub,
    )


def params_from_numpy(src: Any) -> Params:
    """The port's Params from another implementation's parameter fields.

    ``src`` is a mapping or an object carrying the Params field names, with
    ints, bytes and a numpy ``public_challenge`` (for example the JAX
    package's ``Params``): every field is copied by name, so a parameter set
    built elsewhere verifies and builds fleets here unchanged."""
    get = src.__getitem__ if isinstance(src, Mapping) else lambda k: getattr(src, k)
    kw = {}
    for f in fields(Params):
        v = get(f.name)
        if f.name == "public_challenge":
            v = np.array(v, dtype=np.int32)
        elif isinstance(v, (bytes, bytearray)):
            v = bytes(v)
        elif v is not None:
            v = int(v)
        kw[f.name] = v
    return Params(**kw)
