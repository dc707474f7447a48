"""Batched negacyclic NTT / inverse NTT over Z_q on int64 torch tensors.

Port of the JAX package's ``ops/ntt.py`` (the reference's algebra/ntt.py:216-291
Cooley–Tukey forward and :294-377 Gentleman–Sande inverse), as radix-2 stage
sweeps over the trailing axis: a stage with ``m`` blocks of span ``2t`` is a
view ``(..., m, 2, t)`` and lane-wise butterflies.  Twiddles are the powers of
the order-2d root in bit-reversed order, the reference's table layout, so the
forward output is in the same bit-reversed order and the inverse takes it.

The JAX package computes these outside Pallas, so they stay plain torch.  The
inverse transform fused with the verify's norm/weight reduction is the CUDA
kernel of ``ops/intt_norm_weight.py``, which reads this plan's flat tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .field import Field, Q, get_field
from .numtheory import bit_reverse_indices, is_odd_prime, is_primitive_root


@dataclass(frozen=True, eq=False)  # identity hash: plans are interned by make_plan
class NTTPlan:
    """Precomputed twiddle schedule for one (modulus, degree, root) transform."""

    field: Field
    degree: int
    root: int
    inv_root: int
    root_order: int
    # stages: (blocks, span, twiddles int64[blocks]) in application order
    fwd_stages: Tuple[Tuple[int, int, np.ndarray], ...]
    inv_stages: Tuple[Tuple[int, int, np.ndarray], ...]
    n_inv: int
    n_inv_shoup: int
    # flat bit-reversed inverse twiddles (stage with h blocks reads [h:2h])
    # and their Shoup words, uint32 — the layout the CUDA INTT kernel reads
    brp_inv: np.ndarray
    brp_inv_shoup: np.ndarray
    _device_tables: Dict[tuple, object] = field(default_factory=dict, repr=False)

    @property
    def modulus(self) -> int:
        return self.field.q

    def on_device(self, name: str, device: torch.device, build: Callable[[], object]):
        """``build()``'s tensors for ``device``, made once per plan."""
        key = (name, str(device))
        if key not in self._device_tables:
            self._device_tables[key] = build()
        return self._device_tables[key]

    def tables(self, device: torch.device) -> tuple:
        """Per-device stage twiddles: (fwd [int64[m, 1]...], inv [...])."""
        return self.on_device("stages", device, lambda: tuple(
            [torch.as_tensor(s, device=device).view(-1, 1) for _, _, s in stages]
            for stages in (self.fwd_stages, self.inv_stages)
        ))


@lru_cache(maxsize=None)
def make_plan(modulus: int = Q, degree: int = 256, root: Optional[int] = None) -> NTTPlan:
    """Build (and intern) the twiddle tables for one transform size; same
    layout as the JAX package's ``make_plan``."""
    if root is None:
        from .numtheory import find_primitive_root

        root = find_primitive_root(modulus, 2 * degree)
    if not is_odd_prime(modulus):
        raise ValueError(f"modulus={modulus} must be an odd prime")
    root_order = 2 * degree
    if not is_primitive_root(root, modulus, root_order):
        raise ValueError(f"root={root} is not a primitive root of order {root_order}")
    fld = get_field(modulus)
    inv_root = pow(root, modulus - 2, modulus)

    idx = bit_reverse_indices(degree)
    brp = [pow(root, i, modulus) for i in idx]
    brp_inv = [pow(inv_root, i, modulus) for i in idx]

    def stage(tbl: List[int], lo: int, hi: int) -> np.ndarray:
        return np.array(tbl[lo:hi], dtype=np.int64)

    fwd = []
    m = 1
    while m < degree:
        fwd.append((m, degree // (2 * m), stage(brp, m, 2 * m)))
        m *= 2
    inv = []
    h = degree // 2
    while h >= 1:
        inv.append((h, degree // (2 * h), stage(brp_inv, h, 2 * h)))
        h //= 2

    n_inv = pow(degree, modulus - 2, modulus)
    return NTTPlan(
        field=fld,
        degree=degree,
        root=root,
        inv_root=inv_root,
        root_order=root_order,
        fwd_stages=tuple(fwd),
        inv_stages=tuple(inv),
        n_inv=n_inv,
        n_inv_shoup=fld.shoup(n_inv),
        brp_inv=np.array(brp_inv, dtype=np.uint32),
        brp_inv_shoup=np.array([fld.shoup(x) for x in brp_inv], dtype=np.uint32),
    )


def ntt_fwd_u(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of int64 residues along the trailing axis
    (standard order in, bit-reversed order out)."""
    q = plan.modulus
    shape = x.shape
    lead = shape[:-1]
    fwd, _ = plan.tables(x.device)
    for (m, t, _), s in zip(plan.fwd_stages, fwd):
        x = x.reshape(lead + (m, 2, t))
        u = x[..., 0, :]
        v = (x[..., 1, :] * s) % q
        a = u + v
        b = u - v
        x = torch.stack(
            [torch.where(a >= q, a - q, a), torch.where(b < 0, b + q, b)], dim=-2
        )
    return x.reshape(shape)


def ntt_inv_u(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT of int64 residues (bit-reversed order in,
    standard order out, with the final n^-1 scale)."""
    q = plan.modulus
    shape = x.shape
    lead = shape[:-1]
    _, inv = plan.tables(x.device)
    for (h, t, _), s in zip(plan.inv_stages, inv):
        x = x.reshape(lead + (h, 2, t))
        u = x[..., 0, :]
        v = x[..., 1, :]
        a = u + v
        b = u - v
        x = torch.stack(
            [torch.where(a >= q, a - q, a), (torch.where(b < 0, b + q, b) * s) % q],
            dim=-2,
        )
    return (x.reshape(shape) * plan.n_inv) % q
