"""The verify's aggregate check: the observed sum ``A·agg`` and the inverse
NTT fused with the norm/weight reduction, as one CUDA kernel and its plain
version.

Port of the JAX package's ``ops/ntt_mxu_pallas.py`` ``_build_norm_weight``
(reached through ``intt_norm_weight_mxu_pallas``) together with the observed
sum its caller computes beside it (``scheme/device_pipeline.py``
``j_lattice``).  The kernel is in ``csrc/intt_norm_weight.cu`` and reads the
int32 aggregates once; on a CUDA tensor :func:`agg_check` launches it (or
raises), on a CPU tensor it runs :func:`agg_check_plain`.

The lift of an int32 aggregate coefficient is its canonical residue
``x mod q`` for every int32 (the reference's integer semantics).  The JAX
package lifts through uint32, which aliases the values below ``-q``; on
those inputs the two differ, on centered inputs they agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from .field import Field
from .ntt import NTTPlan, ntt_inv_u_plain
from .upload import upload


@dataclass(frozen=True)
class AggTable:
    """The public matrix A [rank, d] in the forms the check reads:
    ``a_mont`` (int64 Montgomery residues, the plain version's) and ``a_u``,
    ``a_sh`` (A mod q and its Shoup words as int32 bit patterns, the
    kernel's)."""

    a_mont: torch.Tensor
    a_u: torch.Tensor
    a_sh: torch.Tensor

    @property
    def rank(self) -> int:
        return self.a_u.shape[0]


def agg_table(field: Field, public_challenge, device: torch.device) -> AggTable:
    """Build the :class:`AggTable` of ``public_challenge`` (int [rank, d])
    on ``device``, from host arrays: one copy per tensor."""
    a = np.mod(np.asarray(public_challenge, dtype=np.int64), field.q)
    a_sh = (a << 32) // field.q
    a_mont = (a * field.r_mod_q) % field.q
    return AggTable(
        a_mont=upload(a_mont, device),
        a_u=upload(a.astype(np.uint32).view(np.int32), device),
        a_sh=upload(a_sh.astype(np.uint32).view(np.int32), device),
    )


def intt_norm_weight_plain(plan: NTTPlan, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64[..., d] NTT-domain residues -> (max |centered coefficient|,
    nonzero-coefficient count), int32[...] each: the plain inverse NTT,
    centering and the row reductions of the reference verify
    (fusion.py:722-727)."""
    coef = plan.field.to_centered(ntt_inv_u_plain(plan, x))
    return coef.abs().amax(dim=-1), (coef != 0).sum(dim=-1, dtype=torch.int32)


def agg_check_plain(plan: NTTPlan, table: AggTable, aggs: torch.Tensor):
    """aggs int[..., rank, d] -> (observed int64[..., d] = sum_r A[r]·agg[r]
    mod q, max |centered coefficient| int32[..., rank], nonzero count
    int32[..., rank]): the lattice stage's torch code."""
    F = plan.field
    agg_u = F.to_unsigned(aggs)
    observed = F.dot_mod(table.a_mont, agg_u, axis=-2)
    nrm, wgt = intt_norm_weight_plain(plan, agg_u)
    return observed, nrm, wgt


def agg_check(plan: NTTPlan, table: AggTable, aggs: torch.Tensor):
    """Same contract as :func:`agg_check_plain`; on CUDA one launch of kernel
    ``intt_norm_weight``, which takes contiguous int32 aggregates, reads
    them once and never writes the coefficients."""
    if aggs.device.type == "cpu":
        return agg_check_plain(plan, table, aggs)
    d, rank, q = plan.degree, table.rank, plan.modulus
    if d < 64 or d > 1024 or d & (d - 1):
        raise ValueError(f"intt_norm_weight kernel needs a power-of-two degree in [64, 1024], got {d}")
    if not (1 << 30) < q < (1 << 31):
        raise ValueError(f"intt_norm_weight kernel needs a modulus in (2**30, 2**31), got {q}")
    if aggs.dim() < 2 or tuple(aggs.shape[-2:]) != (rank, d):
        raise ValueError(f"intt_norm_weight: aggregates of shape {tuple(aggs.shape)}, "
                         f"expected [..., {rank}, {d}]")
    kernels.require_cuda_tensor(aggs, "aggs", torch.int32, aggs.dim())
    lead = aggs.shape[:-2]
    x = kernels.aligned(aggs.view(-1, rank, d))
    if table.a_u.device != x.device:
        raise ValueError(f"intt_norm_weight: table on {table.a_u.device}, aggregates on {x.device}")
    groups = x.shape[0]
    tw, tw_sh = plan.twiddles(True, x.device)
    observed = torch.empty((groups, d), dtype=torch.int64, device=x.device)
    nrm = torch.empty((groups, rank), dtype=torch.int32, device=x.device)
    wgt = torch.empty((groups, rank), dtype=torch.int32, device=x.device)
    lib = kernels.library()
    rc = lib.fct_intt_norm_weight(
        x.data_ptr(), groups, rank, d, table.a_u.data_ptr(), table.a_sh.data_ptr(),
        tw.data_ptr(), tw_sh.data_ptr(), plan.n_inv, plan.n_inv_shoup, q,
        observed.data_ptr(), nrm.data_ptr(), wgt.data_ptr(), kernels.cuda_stream(),
    )
    kernels.LAUNCHES["intt_norm_weight"] += 1
    kernels.check_launch(rc, "intt_norm_weight")
    return observed.view(lead + (d,)), nrm.view(lead + (rank,)), wgt.view(lead + (rank,))
