"""Inverse NTT fused with the verify's norm/weight reduction: CUDA kernel and
its plain version.

Port of the JAX package's ``ops/ntt_mxu_pallas.py`` ``_build_norm_weight``
(reached through ``intt_norm_weight_mxu_pallas``).  The kernel is in
``csrc/intt_norm_weight.cu``; on a CUDA tensor the wrapper launches it (or
raises), on a CPU tensor it runs :func:`intt_norm_weight_plain`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .ntt import NTTPlan, ntt_inv_u_plain


def intt_norm_weight_plain(plan: NTTPlan, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64[..., d] NTT-domain residues -> (max |centered coefficient|,
    nonzero-coefficient count), int32[...] each: the plain inverse NTT,
    centering and the row reductions of the reference verify
    (fusion.py:722-727)."""
    coef = plan.field.to_centered(ntt_inv_u_plain(plan, x))
    return coef.abs().amax(dim=-1), (coef != 0).sum(dim=-1, dtype=torch.int32)


def intt_norm_weight(plan: NTTPlan, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`intt_norm_weight_plain`; on CUDA one launch
    of kernel ``intt_norm_weight``, which never writes the coefficients."""
    if x.device.type == "cpu":
        return intt_norm_weight_plain(plan, x)
    d = plan.degree
    if d < 64 or d > 1024 or d & (d - 1):
        raise ValueError(f"intt_norm_weight kernel needs a power-of-two degree in [64, 1024], got {d}")
    if x.shape[-1] != d:
        raise ValueError(f"intt_norm_weight: trailing axis {x.shape[-1]} != degree {d}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    kernels.require_cuda_tensor(x2, "x", torch.int64, 2)
    rows = x2.shape[0]
    tw, tw_sh = plan.twiddles(True, x.device)
    nrm = torch.empty(rows, dtype=torch.int32, device=x.device)
    wgt = torch.empty(rows, dtype=torch.int32, device=x.device)
    lib = kernels.library()
    rc = lib.fct_intt_norm_weight(
        x2.data_ptr(), rows, d, tw.data_ptr(), tw_sh.data_ptr(),
        plan.n_inv, plan.n_inv_shoup, plan.modulus,
        nrm.data_ptr(), wgt.data_ptr(), kernels.cuda_stream(),
    )
    kernels.LAUNCHES["intt_norm_weight"] += 1
    kernels.check_launch(rc, "intt_norm_weight")
    return nrm.view(lead), wgt.view(lead)
