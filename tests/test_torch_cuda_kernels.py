"""The port's CUDA kernels, compiled, vs their plain torch versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc (sm_90a) and skip
without one.  Run on the GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""
from hashlib import shake_256

import numpy as np
import pytest
import torch

from fusion_cryptography_tpu_torch import kernels
from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks
from fusion_cryptography_tpu_torch.ops.field import Q
from fusion_cryptography_tpu_torch.ops.intt_norm_weight import (
    intt_norm_weight,
    intt_norm_weight_plain,
)
from fusion_cryptography_tpu_torch.ops.ntt import make_plan

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kernels.library()
    return torch.device("cuda", 0)


def test_sponge_kernels_match_plain_and_hashlib(dev):
    rng = np.random.default_rng(1)
    lens = np.array([0, 1, 135, 136, 137, 700] + list(rng.integers(0, 1000, 294)), np.int32)
    B = lens.size  # not a multiple of the block size: the edge is masked
    rows = -(-(1000 + 1) // keccak.RATE) * keccak.RATE_WORDS
    by = rng.integers(0, 256, size=(B, 4 * rows), dtype=np.uint8)
    by[np.arange(4 * rows)[None, :] >= lens[:, None]] = 0
    words = torch.from_numpy(by.view(np.int32).T.copy()).to(dev)
    L = torch.from_numpy(lens).to(dev)
    padded, nb = ks._pad_words_lm(words, L)
    st = ks.absorb(padded, nb)
    torch.cuda.synchronize()
    assert torch.equal(st, keccak.absorb_padded(padded, nb))
    for n_words in (1, 34, 35, 2106):
        out = ks.squeeze(st, n_words)
        assert torch.equal(out, keccak.shake256_squeeze_words(st, n_words))
    got = ks.shake256_words_w(words, L, 50).t().contiguous().view(torch.uint8).cpu().numpy()
    for i in range(0, B, 37):
        assert got[i].tobytes() == shake_256(by[i, : lens[i]].tobytes()).digest(200)


@pytest.mark.parametrize("d,root,rows", [(64, 23584283, 333), (256, 3337519, 1001)])
def test_intt_norm_weight_kernel_matches_plain(dev, d, root, rows):
    plan = make_plan(Q, d, root)
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randint(0, Q, (rows, d), dtype=torch.int64, device=dev, generator=g)
    x[::5] = 0
    x[1, :] = Q - 1
    nk, wk = intt_norm_weight(plan, x)
    torch.cuda.synchronize()
    np_, wp = intt_norm_weight_plain(plan, x)
    assert torch.equal(nk, np_) and torch.equal(wk, wp)


def test_wrappers_check_their_inputs(dev):
    plan = make_plan(Q, 256, 3337519)
    with pytest.raises(ValueError):
        intt_norm_weight(plan, torch.zeros((8, 512), dtype=torch.int64, device=dev)[:, ::2])
    with pytest.raises(ValueError):
        ks.absorb(torch.zeros((34, 8), dtype=torch.int64, device=dev),
                  torch.ones(8, dtype=torch.int32, device=dev))


def test_pipeline_on_cuda_equals_cpu(dev):
    from fusion_cryptography_tpu_torch import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params = fusion_setup(256, 3)
    vks, msgs, aggs = build_fleet(params, 5, 3, seed0=9, device=dev)
    before = dict(kernels.LAUNCHES)
    out_c = dp.derive_coeffs_device(params, vks, msgs, aggs, group_chunk=2)
    assert all(kernels.LAUNCHES[k] > before.get(k, 0)
               for k in ("keccak_absorb", "keccak_squeeze", "intt_norm_weight"))
    out_h = dp.derive_coeffs_device(params, vks.cpu(), msgs, aggs.cpu())
    for a, b in zip(out_c, out_h):
        assert torch.equal(a.cpu(), b)
    assert bool(out_c[0].all())
