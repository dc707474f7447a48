"""The scheme's NTT-domain formulas, for the lifecycle, the fleet build, the
object API and the sharded step, on int64 residues in [0, q) of any leading
shape.  A product is ``(a * b) % q`` (exact below 2**62; ops/field.py's
``mont_mul(to_mont(a), b)`` bit for bit), one temporary reduced in place."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.ntt import ntt_fwd
from ..ops.upload import upload
from ..params import Params


def mul(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """a ⊙ b mod q, broadcast."""
    return torch.mul(a, b).remainder_(q)


def sign(q: int, sk: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sig = sk_l ⊙ ĉ + sk_r (fusion.py:534-557): sk [..., 2, r, d] and ĉ
    [..., d] -> [..., r, d], ĉ broadcast over the r rows."""
    return mul(sk[..., 0, :, :], c.unsqueeze(-2), q).add_(sk[..., 1, :, :]).remainder_(q)


def aggregate(q: int, alpha: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """agg = Σ α̂ ⊙ sig over the N signers (fusion.py:670-677): α̂ [..., N, d]
    and sig [..., N, r, d] -> [..., r, d]."""
    return mul(sig, alpha.unsqueeze(-2), q).sum(dim=-3).remainder_(q)


@lru_cache(maxsize=16)
def _a_sum(params: Params, device: str) -> torch.Tensor:
    a = np.mod(params.public_challenge.astype(np.int64), params.modulus)  # [rank, d]
    return upload(a.sum(axis=0) % params.modulus, device)


def keygen(params: Params, coeffs: torch.Tensor, device: torch.device):
    """Sampled short coefficients int32[B, 2, d] on ``device``
    (``device_setup._sample_sk``) -> (sk_hat, vk) int32[B, 2, d] centered
    there: sk_hat = NTT(sk), vk = A·sk (fusion.py:338-373), which is
    (Σ_r A_r)·sk, since the reference reseeds per matrix entry (all rank
    entries of a key are one polynomial); Σ_r A_r is made once a device."""
    F, q = params.plan.field, params.modulus
    sk_hat = ntt_fwd(params.plan, coeffs)
    return sk_hat, F.to_centered(mul(F.to_unsigned(sk_hat), _a_sum(params, str(device)), q))
