"""The three preimage folds on the CPU (the kernels' plain versions) vs the
JAX package's fold kernels in interpret mode, as tests/test_fold_pallas.py
runs them.  The pipeline that runs them is held against JAX's coefficients,
verdicts and fleet build in tests/test_torch_pipeline.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import device_serial as jds
from fusion_cryptography_tpu.ops import fold_pallas as jfp
from fusion_cryptography_tpu.ops import ragged_words as jrw
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.ops import preimage_fold as pf


def _i32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.fixture(scope="module")
def folds():
    """secpar=128, B=8 lanes with ragged prehash lengths (1..78 digits), the
    inputs of tests/test_fold_pallas.py, through both packages' folds."""
    jp = ftpu.fusion_setup(128, 42)
    p = params_from_numpy(jp)
    B, d, q = 8, jp.degree, jp.modulus
    rng = np.random.default_rng(11)
    vk2d_t = rng.integers(-(q // 2), q // 2 + 1, (2 * d, B), dtype=np.int64).astype(np.int32)
    c_hat_t = rng.integers(-(q // 2), q // 2 + 1, (d, B), dtype=np.int64).astype(np.int32)
    vk2d_t[:3, 0] = [0, 1, -1]
    lens = rng.integers(1, jds.PREHASH_W + 1, B).astype(np.int32)
    by = np.zeros((jds.PREHASH_W + 2, B), np.uint8)
    for b in range(B):
        by[: lens[b], b] = rng.integers(ord("1"), ord("9"), lens[b])
    pre_w = np.asarray(jrw.pack_bytes_to_words(jnp.asarray(by)))

    ja = jfp.signer_fold_a(jp, jnp.asarray(vk2d_t), jnp.asarray(pre_w), jnp.asarray(lens),
                           tile=8, interpret=True)
    jb = jfp.signer_fold_b(jp, ja[2], ja[3], jnp.asarray(pre_w), jnp.asarray(lens),
                           jnp.asarray(c_hat_t), tile=8, interpret=True)
    t = lambda a: torch.from_numpy(np.array(_i32(a)))  # noqa: E731
    ta = pf.signer_fold_a(p, t(vk2d_t), t(pre_w), t(lens))
    tb = pf.signer_fold_b(p, ta[2], ta[3], t(pre_w), t(lens), t(c_hat_t))
    return jp, p, ja, jb, ta, tb


def test_signer_folds_match_jax(folds):
    _, _, ja, jb, ta, tb = folds
    # (ch_wbuf, ch_total, vk_buf with its zero tail, vk_len), (tri_wbuf, tri_total)
    for got, want in zip((*ta, *tb), (*ja, *jb)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _i32(want))


def test_agg_fold_matches_jax(folds):
    jp, p, _, jb, _, tb = folds
    N = 3
    # three different signer columns per group: roll the batch
    jtbs = [jnp.roll(jb[0], k, axis=1) for k in range(N)]
    jtls = [jnp.roll(jb[1], k) for k in range(N)]
    want = jfp.agg_fold(jp, N, jtbs, jtls, tile=8, interpret=True)
    # the port takes the N triples as views [Wtri, N, G] and [N, G]
    got = pf.agg_fold(p, N, torch.stack([torch.roll(tb[0], k, dims=1) for k in range(N)], dim=1),
                      torch.stack([torch.roll(tb[1], k) for k in range(N)]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _i32(w))
