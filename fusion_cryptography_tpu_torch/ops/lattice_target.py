"""The lattice check's target half: the target sum, its comparison with the
observed sum, and the norm and weight limits, as one CUDA kernel and its
plain version.

Port of the part of the JAX package's ``scheme/device_pipeline.py``
``j_lattice`` that XLA compiles around the aggregate check:

  target[g, i] = sum_k alpha_hat[g,k,i] * (c_hat[g,k,i] * vk_l[g,k,i] + vk_r[g,k,i]) mod q
  eq[g]        = all_i target[g, i] == observed[g, i]
  norm_ok[g]   = max_r nrm[g, r] <= beta,   weight_ok[g] = max_r wgt[g, r] <= omega

(``ops/field.py`` ``to_unsigned``, ``to_mont``, ``mont_mul``, ``add_mod``,
``sum_mod``).  On a CUDA tensor :func:`lattice_target` launches
``csrc/lattice_target.cu``: once, a warp a group, when the groups fill the
card; with few groups of many signers twice, each group's signers split
into :func:`lattice_split` slices.  On a CPU tensor it runs
:func:`lattice_target_plain`.  Both take c_hat and alpha_hat as residues in
[0, q) (the NTT's output) and lift the int32 vk values to x mod q.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from .field import Field

WARPS_PER_SM = 16  # a split launch's aim: 4 warps on each of an SM's 4 schedulers
MIN_SLICE_SIGNERS = 8  # a slice reads at least 8 signers' rows (~48 KB at d=256)


def lattice_split(groups: int, n_signers: int, sms: int) -> int:
    """Slices of each group's signers for kernel ``lattice_target``: 1 (a
    warp a group, one launch) while the groups give every SM 16 warps, else
    enough to do so, with at least 8 signers a slice."""
    want = -(-WARPS_PER_SM * sms // max(1, groups))
    return max(1, min(want, n_signers // MIN_SLICE_SIGNERS))


def lattice_target_plain(field: Field, vks: torch.Tensor, c_hat_u: torch.Tensor,
                         alpha_u: torch.Tensor, observed: torch.Tensor, nrm: torch.Tensor,
                         wgt: torch.Tensor, beta: int, omega: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """vks int32[G, N, 2, d], c_hat_u and alpha_u int64[G, N, d], observed
    int64[G, d], nrm and wgt int32[G, rank] -> (eq, norm_ok, weight_ok)
    bool[G], in torch."""
    F = field
    vk_u = F.to_unsigned(vks)  # [G, N, 2, d]
    t = F.add_mod(F.mont_mul(F.to_mont(c_hat_u), vk_u[..., 0, :]), vk_u[..., 1, :])
    target = F.sum_mod(F.mont_mul(F.to_mont(alpha_u), t), axis=-2)  # [G, d]
    eq = torch.all(target == observed, dim=-1)
    return eq, nrm.amax(dim=-1) <= beta, wgt.amax(dim=-1) <= omega


def lattice_target(field: Field, vks: torch.Tensor, c_hat_u: torch.Tensor,
                   alpha_u: torch.Tensor, observed: torch.Tensor, nrm: torch.Tensor,
                   wgt: torch.Tensor, beta: int, omega: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`lattice_target_plain`; ``beta`` and ``omega``
    must lie in int64.  On CUDA kernel ``lattice_target``, its signers in
    :func:`lattice_split`'s slices."""
    if vks.device.type == "cpu":
        return lattice_target_plain(field, vks, c_hat_u, alpha_u, observed, nrm, wgt, beta,
                                    omega)
    return _lattice_target_launch(field, vks, c_hat_u, alpha_u, observed, nrm, wgt, beta, omega)


def _lattice_target_launch(field: Field, vks, c_hat_u, alpha_u, observed, nrm, wgt, beta: int,
                           omega: int, slices: Optional[int] = None,
                           out: Optional[torch.Tensor] = None):
    """Kernel ``lattice_target`` in ``slices`` slices of the signers
    (default :func:`lattice_split`'s; tests and chip_smoke hold both ways),
    its verdicts into ``out`` (bool[3, G] on the card, for example
    pre-filled by a test) or new tensors."""
    if vks.dim() != 4 or vks.shape[2] != 2:
        raise ValueError(f"lattice_target: vks of shape {tuple(vks.shape)}, expected [G, N, 2, d]")
    G, N, _, d = vks.shape
    q = field.q
    if not (1 << 30) < q < (1 << 31):
        raise ValueError(f"lattice_target kernel needs a modulus in (2**30, 2**31), got {q}")
    rank = nrm.shape[-1]
    shapes = ((c_hat_u, (G, N, d), torch.int64), (alpha_u, (G, N, d), torch.int64),
              (observed, (G, d), torch.int64), (nrm, (G, rank), torch.int32),
              (wgt, (G, rank), torch.int32))
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != vks.device:
            raise ValueError(f"lattice_target: expected {dtype}{list(shape)} on {vks.device}, "
                             f"got {t.dtype}{list(t.shape)} on {t.device}")
    ins = [x.contiguous() for x in (vks, c_hat_u, alpha_u, observed, nrm, wgt)]
    kernels.require_cuda_tensor(ins[0], "vks", torch.int32, 4)
    if slices is None:
        slices = lattice_split(G, N, torch.cuda.get_device_properties(
            vks.device).multi_processor_count)
    slices = max(1, min(int(slices), N))
    partial = (torch.empty((slices, G, d), dtype=torch.int32, device=vks.device)
               if slices > 1 else None)
    (out,) = kernels.outputs(None if out is None else [out], [(3, G)], vks.device, torch.bool)
    rc = kernels.library().fct_lattice_target(
        *(x.data_ptr() for x in ins), G, N, d, rank, q, (1 << 64) // q, int(beta), int(omega),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), slices,
        None if partial is None else partial.data_ptr(), kernels.cuda_stream())
    kernels.LAUNCHES["lattice_target"] += 1 if partial is None else 2
    kernels.check_launch(rc, "lattice_target")
    return out[0], out[1], out[2]
