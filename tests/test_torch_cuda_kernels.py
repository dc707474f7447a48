"""The port's CUDA kernels, compiled, vs their plain torch versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc (sm_90a) and skip
without one.  Run on the GPU machine (which has no JAX, hence no conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``."""
from hashlib import shake_256

import numpy as np
import pytest
import torch

from fusion_cryptography_tpu_torch import kernels
from fusion_cryptography_tpu_torch import fusion_setup
from fusion_cryptography_tpu_torch.interop import device_serial as ds
from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks
from fusion_cryptography_tpu_torch.ops import preimage_fold as pf
from fusion_cryptography_tpu_torch.ops import ragged_words as rw
from fusion_cryptography_tpu_torch.ops.assemble_spec import _assemble_spec_launch as \
    assemble_spec_launch
from fusion_cryptography_tpu_torch.ops.assemble_spec import assemble_spec
from fusion_cryptography_tpu_torch.ops.field import Q
from fusion_cryptography_tpu_torch.ops.intt_norm_weight import agg_check, agg_check_plain, agg_table
from fusion_cryptography_tpu_torch.ops import ntt
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


@pytest.mark.parametrize("B", [1, 31, 33, 8197])
def test_absorb_kernel_any_batch_and_counts(dev, B):
    """Kernel ``keccak_absorb`` at one and two threads per sponge and
    through the wrapper, against the plain absorb exactly, on random words
    (the absorb reads no padding): all counts 0; counts of 0 and max_blocks
    mixed; counts from -3 to max_blocks + 3 (clamped).  At each team the
    kernel writes into a state pre-filled with -1, so a word it leaves
    unwritten fails."""
    max_blocks = 5
    rng = np.random.default_rng(B)
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(max_blocks * 34, B),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    mixed = rng.choice([0, max_blocks], B)
    mixed[0] = max_blocks
    wide = rng.integers(-3, max_blocks + 4, B)
    wide[0], wide[-1] = max_blocks + 1, -1
    for counts in (np.zeros(B), mixed, wide):
        nb = torch.from_numpy(counts.astype(np.int32)).to(dev)
        want = keccak.absorb_padded(words, nb)
        for team in (1, 2):
            state = torch.full((50, B), -1, dtype=torch.int32, device=dev)
            assert ks._absorb_launch(words, nb, team, state) is state
            assert torch.equal(state, want)
        assert torch.equal(ks.absorb(words, nb), want)


@pytest.mark.parametrize("B", [1, 17, 8192 + 3])
def test_squeeze_kernel_both_teams(dev, B):
    """Kernel ``keccak_squeeze`` at one and two threads per sponge and
    through the wrapper == the plain squeeze, into words pre-filled with -1,
    on random states: one rate block or less (1, 8, 34 words), a partial
    last block (35, 300), whole blocks (68), and the widths of a verify
    call's challenge (2,106) and aggregation (3,968) squeezes."""
    rng = np.random.default_rng(B + 7)
    state = torch.from_numpy(rng.integers(-(2**31), 2**31, (50, B),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    for n_words in (1, 8, 34, 35, 68, 300, 2106, 3968):
        want = keccak.shake256_squeeze_words(state, n_words)
        for team in (1, 2):
            out = torch.full((n_words, B), -1, dtype=torch.int32, device=dev)
            assert ks._squeeze_launch(state, n_words, team, out) is out
            assert torch.equal(out, want)
        assert torch.equal(ks.squeeze(state, n_words), want)
    with pytest.raises(RuntimeError):  # no such team: the launch is refused
        ks._squeeze_launch(state, 8, 3)


# secpar 128 and 256 (rank 195 and 83) over the Fusion prime, G not a
# multiple of anything; d = 512 and 1024 over 2013265921 = 15 * 2**27 + 1
@pytest.mark.parametrize("q,d,root,rank,G", [(Q, 64, 23584283, 195, 37), (Q, 256, 3337519, 83, 53),
                                             (2013265921, 512, 341742893, 9, 5),
                                             (2013265921, 1024, 1340477990, 7, 3)])
def test_intt_norm_weight_kernel_matches_plain(dev, q, d, root, rank, G):
    """Kernel ``intt_norm_weight`` (the aggregate check) == agg_check_plain
    on centered values, a zero row, every in-range edge and, over the
    Fusion prime, every out-of-range int32 edge and random int32 rows."""
    plan = make_plan(q, d, root)
    rng = np.random.default_rng(d + rank)
    x = rng.integers(-(q // 2), q // 2 + 1, size=(G, rank, d), dtype=np.int64)
    x[0, 0] = 0
    edges = [0, 1, -1, q // 2, -(q // 2)]
    if q == Q:  # the plain version is exact on out-of-range int32 for this q
        edges += [q // 2 + 1, -(q // 2) - 1, q - 1, q, -q, -q - 1, 2**31 - 1, -(2**31)]
        x[1, 1], x[1, 2] = -(2**31), 2**31 - 1
        x[-1, -3:] = rng.integers(-(2**31), 2**31, size=(3, d))
    x[1, 0, : len(edges)] = edges
    x[2, :, :5] = 0  # rows of weight below d
    aggs = torch.from_numpy(x.astype(np.int32)).to(dev)
    pub = rng.integers(-(q // 2), q // 2 + 1, size=(rank, d))
    before = kernels.LAUNCHES["intt_norm_weight"]
    got = agg_check(plan, agg_table(plan.field, pub, dev), aggs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["intt_norm_weight"] == before + 1
    want = agg_check_plain(plan, agg_table(plan.field, pub, dev), aggs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    lead = agg_check(plan, agg_table(plan.field, pub, dev), aggs[:2].reshape(1, 2, rank, d))
    assert all(torch.equal(g.reshape(w[:2].shape), w[:2]) for g, w in zip(lead, want))


@pytest.mark.parametrize("d,root,rows", [(64, 23584283, 333), (256, 3337519, 1001),
                                         (64, 23584283, 1001), (256, 3337519, 333)])
def test_ntt_kernels_match_plain(dev, d, root, rows):
    """Both kernels, both directions: residues with rows of 0 and q-1,
    centered values with 0, +-1 and +-(q-1)/2."""
    plan = make_plan(Q, d, root)
    g = torch.Generator(device=dev).manual_seed(rows + d)
    u = torch.randint(0, Q, (rows, d), dtype=torch.int64, device=dev, generator=g)
    u[0], u[1] = 0, Q - 1
    c = (torch.randint(0, Q, (rows, d), dtype=torch.int64, device=dev, generator=g)
         - Q // 2).to(torch.int32)
    c[0, :5] = torch.tensor([0, 1, -1, Q // 2, -(Q // 2)], dtype=torch.int32)
    c[1] = -(Q // 2)
    before = dict(kernels.LAUNCHES)
    pairs = [(ntt.ntt_fwd_u(plan, u), ntt.ntt_fwd_u_plain(plan, u)),
             (ntt.ntt_inv_u(plan, u), ntt.ntt_inv_u_plain(plan, u)),
             (ntt.ntt_fwd(plan, c), ntt.ntt_fwd_plain(plan, c)),
             (ntt.ntt_inv(plan, c), ntt.ntt_inv_plain(plan, c))]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ntt_u"] == before.get("ntt_u", 0) + 2
    assert kernels.LAUNCHES["ntt_centered"] == before.get("ntt_centered", 0) + 2
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ntt.ntt_inv_u(plan, pairs[0][0]), u)
    lead = c[:15].reshape(3, 5, d)  # any leading shape
    assert torch.equal(ntt.ntt_fwd(plan, lead), pairs[2][0][:15].reshape(3, 5, d))


def test_wrappers_check_their_inputs(dev):
    plan = make_plan(Q, 256, 3337519)
    with pytest.raises(ValueError):  # residues as int32
        ntt.ntt_fwd_u(plan, torch.zeros((4, 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # centered values as int64
        ntt.ntt_fwd(plan, torch.zeros((4, 256), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # trailing axis is not the degree
        ntt.ntt_inv_u(plan, torch.zeros((4, 64), dtype=torch.int64, device=dev))
    table = agg_table(plan.field, np.zeros((3, 256), np.int64), dev)
    with pytest.raises(ValueError):  # aggregates not contiguous
        agg_check(plan, table, torch.zeros((2, 3, 512), dtype=torch.int32, device=dev)[..., ::2])
    with pytest.raises(ValueError):  # aggregates as int64
        agg_check(plan, table, torch.zeros((2, 3, 256), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # rank other than the table's
        agg_check(plan, table, torch.zeros((2, 4, 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # table on the CPU
        agg_check(plan, agg_table(plan.field, np.zeros((3, 256), np.int64), torch.device("cpu")),
                  torch.zeros((2, 3, 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        ks.absorb(torch.zeros((34, 8), dtype=torch.int64, device=dev),
                  torch.ones(8, dtype=torch.int32, device=dev))
    params = fusion_setup(128, 1)
    d, B = params.degree, 8
    z = torch.zeros((2 * d, B), dtype=torch.int32, device=dev)
    pre_w = torch.zeros((pf.PRE_ROWS, B), dtype=torch.int32, device=dev)
    pre_len = torch.ones(B, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # prehash digits on the CPU
        pf.signer_fold_a(params, z, pre_w.cpu(), pre_len)
    with pytest.raises(ValueError):  # int64 lengths
        pf.signer_fold_a(params, z, pre_w, pre_len.long())
    with pytest.raises(ValueError):  # triples of different strides
        tri = torch.zeros((801, 2 * B), dtype=torch.int32, device=dev)
        pf.agg_fold(params, 2, [tri[:, :B], tri[:, ::2]], [pre_len, pre_len])


@pytest.mark.parametrize("secpar", [128, 256])
def test_fold_kernels_match_plain(dev, secpar):
    """B=300 lanes (a ragged edge of every launch geometry)."""
    params = fusion_setup(secpar, 2)
    d, q, B, N = params.degree, params.modulus, 300, 4
    rng = np.random.default_rng(secpar)
    vals = rng.integers(-(q // 2), q // 2 + 1, (3 * d, B), dtype=np.int64)
    vals[:5, 0] = [0, 1, -1, q // 2, -(q // 2)]
    vals = torch.from_numpy(vals.astype(np.int32)).to(dev)
    vk2d_t, c_hat_t = vals[: 2 * d].contiguous(), vals[2 * d :].contiguous()
    lens = rng.integers(1, ds.PREHASH_W + 1, B).astype(np.int32)
    by = rng.integers(ord("0"), ord("9") + 1, (B, 4 * pf.PRE_ROWS), dtype=np.uint8)
    by[np.arange(4 * pf.PRE_ROWS)[None, :] >= lens[:, None]] = 0
    pre_w = torch.from_numpy(by.view(np.int32).T.copy()).to(dev)
    pre_len = torch.from_numpy(lens).to(dev)

    before = dict(kernels.LAUNCHES)
    got_a = pf.signer_fold_a(params, vk2d_t, pre_w, pre_len)
    got_b = pf.signer_fold_b(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)
    G = B // N
    tb = got_b[0][:, : G * N].reshape(-1, G, N)
    tl = got_b[1][: G * N].reshape(G, N)
    got_g = pf.agg_fold(params, N, [tb[:, :, k] for k in range(N)], [tl[:, k] for k in range(N)])
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] == before.get(k, 0) + 1
               for k in ("signer_fold_a", "signer_fold_b", "agg_fold"))
    want_a = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    want_b = pf.signer_fold_b_plain(params, want_a[2], want_a[3], pre_w, pre_len, c_hat_t)
    wtb = want_b[0][:, : G * N].reshape(-1, G, N)
    wtl = want_b[1][: G * N].reshape(G, N)
    want_g = pf.agg_fold_plain(params, N, [wtb[:, :, k].contiguous() for k in range(N)],
                               [wtl[:, k].contiguous() for k in range(N)])
    for got, want in zip((*got_a, *got_b, *got_g), (*want_a, *want_b, *want_g)):
        assert torch.equal(got, want)
    # separate contiguous buffers (no shared base) through the pointer table
    got_c = pf.agg_fold(params, N, [tb[:, :, k].contiguous() for k in range(N)],
                        [tl[:, k].contiguous() for k in range(N)])
    assert all(torch.equal(g, w) for g, w in zip(got_c, want_g))


@pytest.mark.parametrize("B", [1, 4, 33, 32768 - 37])
@pytest.mark.parametrize("secpar", [128, 256])
def test_signer_fold_kernels_any_batch(dev, secpar, B):
    """Kernels ``signer_fold_a`` and ``signer_fold_b`` (a warp a tile of
    lanes, rows staged in shared memory) == their plain versions word for
    word, into outputs pre-filled with -1: a first warp whose lanes 0 and 1
    drift more than a ring apart (every value "0" against every value in 11
    bytes), B = 1, 4 (the lifecycle's one group), 33 and 32,768 - 37 (a last
    warp and a last block part full); then through the wrappers."""
    from test_torch_kernel_host import drift_fold_inputs

    params = fusion_setup(secpar, 4)
    vk2d_t, c_hat_t, pre_w, pre_len = (t.to(dev) for t in drift_fold_inputs(params, B, B))
    want_a = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    want_b = pf.signer_fold_b_plain(params, want_a[2], want_a[3], pre_w, pre_len, c_hat_t)
    before = dict(kernels.LAUNCHES)
    outs_a = [torch.full_like(w, -1) for w in want_a]
    got_a = pf._signer_fold_a_launch(params, vk2d_t, pre_w, pre_len, outs_a)
    outs_b = [torch.full_like(w, -1) for w in want_b]
    got_b = pf._signer_fold_b_launch(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t, outs_b)
    torch.cuda.synchronize()
    assert all(g is o for g, o in zip((*got_a, *got_b), (*outs_a, *outs_b)))
    for got, want in zip((*got_a, *got_b), (*want_a, *want_b)):
        assert torch.equal(got, want)
    got_a = pf.signer_fold_a(params, vk2d_t, pre_w, pre_len)
    got_b = pf.signer_fold_b(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)
    assert all(torch.equal(g, w) for g, w in zip((*got_a, *got_b), (*want_a, *want_b)))
    assert all(kernels.LAUNCHES[k] == before.get(k, 0) + 2
               for k in ("signer_fold_a", "signer_fold_b"))


@pytest.mark.parametrize("signer_major", [False, True], ids=["group_major", "signer_major"])
@pytest.mark.parametrize("secpar,N,G", [(128, 1, 37), (128, 3, 1), (128, 2, 64),
                                        (256, 2, 65), (256, 4, 1), (256, 4, 300)])
def test_agg_fold_kernel_matches_plain(dev, secpar, N, G, signer_major):
    """Kernel ``agg_fold`` == agg_fold_plain on stand-in triples of lengths
    over the triple's whole range (group 0's first triple the shortest,
    group 1's the longest: one tile spreads over the whole range), G = 1,
    G a multiple of the 32-group tile and not, both lane orders."""
    from test_torch_kernel_host import agg_triples

    params = fusion_setup(secpar, 2)
    tbs, tls = agg_triples(params, G, N, secpar + 10 * N + G, signer_major, device=dev)
    before = kernels.LAUNCHES["agg_fold"]
    got = pf.agg_fold(params, N, tbs, tls)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["agg_fold"] == before + 1
    want = pf.agg_fold_plain(params, N, tbs, tls)
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("secpar", [128, 256])
def test_assemble_spec_kernel_matches_plain(dev, secpar):
    """B=300 lanes: the challenge spec (rate-padded), the triple spec, and
    the aggregation spec over N=4 strided triple views, with empty and
    full-width extras."""
    params = fusion_setup(secpar, 2)
    d, q, B, N = params.degree, params.modulus, 300, 4
    rng = np.random.default_rng(secpar + 1)
    vals = rng.integers(-(q // 2), q // 2 + 1, (3 * d, B), dtype=np.int64)
    vals[:5, 0] = [0, 1, -1, q // 2, -(q // 2)]
    tvals = torch.from_numpy(vals.astype(np.int32)).to(dev)
    lens = rng.integers(0, ds.PREHASH_W + 1, B).astype(np.int32)
    lens[:2] = [0, ds.PREHASH_W]
    by = rng.integers(ord("0"), ord("9") + 1, (B, 4 * pf.PRE_ROWS), dtype=np.uint8)
    by[np.arange(4 * pf.PRE_ROWS)[None, :] >= lens[:, None]] = 0
    pre = [(torch.from_numpy(by.view(np.int32).T.copy()).to(dev), torch.from_numpy(lens).to(dev))]
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    before = kernels.LAUNCHES["assemble_spec"]
    pad = ds.signer_fold_a_table(params).widths[0]
    got = assemble_spec(ch_spec, tvals[: 2 * d].contiguous(), pre, pad_words=pad)
    want = ds.assemble_chunks_words(ch_spec, tvals[: 2 * d].contiguous(), pre, pad_words=pad)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    tb, tl = assemble_spec(tri_spec, tvals, pre)
    want = ds.assemble_chunks_words(tri_spec, tvals, pre)
    assert torch.equal(tb, want[0]) and torch.equal(tl, want[1])
    G = B // N
    tbv = tb[:, : G * N].reshape(tb.shape[0], G, N)
    tlv = tl[: G * N].reshape(G, N)
    extras = [(tbv[:, :, k], tlv[:, k]) for k in range(N)]
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    got = assemble_spec(agg_spec, None, extras)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["assemble_spec"] == before + 3
    want = ds.assemble_chunks_words(agg_spec, None, [(b.contiguous(), n.contiguous())
                                                     for b, n in extras])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):  # prehash words on the CPU
        assemble_spec(tri_spec, tvals, [(pre[0][0].cpu(), pre[0][1])])
    with pytest.raises(ValueError):  # extra of the wrong width
        assemble_spec(agg_spec, None, [(tb[:-1], tl)] * N)
    assert rw.words_for(tri_spec.out_max) == tb.shape[0]


@pytest.mark.parametrize("B", [1, 4, 33, 69, 32768 - 37])
@pytest.mark.parametrize("secpar", [128, 256])
def test_assemble_spec_kernel_any_batch(dev, secpar, B):
    """Kernel ``assemble_spec`` (a warp a tile of 32 lanes, rows staged in
    shared memory) == assemble_chunks_words word for word, into outputs
    pre-filled with -1: the challenge spec (rate-padded) and the triple
    spec on a first warp whose lanes 0 and 1 drift more than a ring apart,
    B = 1, 4 (one group), 33, 69 and 32,768 - 37 (a last warp and a last
    block part full); the aggregation spec over N = 3 strided views of the
    triples (B // 3 groups, at least 1)."""
    from test_torch_kernel_host import drift_fold_inputs

    params = fusion_setup(secpar, 4)
    vk2d_t, c_hat_t, pre_w, pre_len = (t.to(dev) for t in drift_fold_inputs(params, B, B + 1))
    pre = [(pre_w, pre_len)]
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    N = 3
    G = max(B // N, 1)
    tvals = torch.cat([vk2d_t, c_hat_t])
    want_t = ds.assemble_chunks_words(tri_spec, tvals, pre)
    tbv = want_t[0][:, : G * N] if B >= N else want_t[0][:, :1].expand(-1, N)
    tlv = want_t[1][: G * N] if B >= N else want_t[1][:1].expand(N)
    tbv, tlv = tbv.reshape(tbv.shape[0], G, N), tlv.reshape(G, N)
    extras = [(tbv[:, :, k], tlv[:, k]) for k in range(N)]
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    cases = [(ch_spec, vk2d_t, pre, ds.signer_fold_a_table(params).widths[0]),
             (tri_spec, tvals, pre, None),
             (agg_spec, None, extras, ds.agg_fold_table(params, N).widths[0])]
    before = kernels.LAUNCHES["assemble_spec"]
    for spec, values, ex, pad in cases:
        want = ds.assemble_chunks_words(spec, values, ex, pad_words=pad)
        outs = tuple(torch.full_like(w, -1) for w in want)
        got = assemble_spec_launch(spec, values, ex, pad, outs)
        torch.cuda.synchronize()
        assert all(g is o for g, o in zip(got, outs))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for g, w in zip(assemble_spec(spec, values, ex, None, pad),
                                                     want))
    assert kernels.LAUNCHES["assemble_spec"] == before + 2 * len(cases)


@pytest.mark.parametrize("secpar", [128, 256])
def test_pipeline_on_cuda_equals_cpu(dev, secpar):
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params = fusion_setup(secpar, 3)
    before = dict(kernels.LAUNCHES)
    vks, msgs, aggs = build_fleet(params, 5, 3, seed0=9, device=dev)
    out_c = dp.derive_coeffs_device(params, vks, msgs, aggs, group_chunk=2)
    assert all(kernels.LAUNCHES[k] > before.get(k, 0)
               for k in ("keccak_absorb", "keccak_squeeze", "intt_norm_weight",
                         "signer_fold_a", "signer_fold_b", "agg_fold"))
    hv, hm, ha = build_fleet(params, 5, 3, seed0=9, device="cpu")
    assert torch.equal(vks.cpu(), hv) and msgs == hm and torch.equal(aggs.cpu(), ha)
    out_h = dp.derive_coeffs_device(params, hv, hm, ha)
    for a, b in zip(out_c, out_h):
        assert torch.equal(a.cpu(), b)
    assert bool(out_c[0].all())


@pytest.mark.parametrize("secpar", [128, 256])
def test_lifecycle_on_cuda_equals_cpu(dev, secpar):
    """keygen -> sign -> aggregate/verify of every prefix N = 1..4 (the fold
    kernels at N != 4) -> verify_many, on the card and on the CPU."""
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    params = fusion_setup(secpar, 3)
    seeds, msgs = [31, 32, 33, 31], ["a", "b", "c", "d"]  # key 31 twice: a tie in the sort
    out = {}
    for where in (dev, "cpu"):
        keys = lc.keygen(params, seeds, device=where)
        sigs = lc.sign(params, keys, msgs)
        aggs = [lc.aggregate(params, keys.vk[:n], msgs[:n], sigs.sig[:n]) for n in range(1, 5)]
        verdicts = [lc.verify(params, keys.vk[:n], msgs[:n], a) for n, a in zip(range(1, 5), aggs)]
        many = lc.verify_many(params, [(keys.vk[:n], msgs[:n], a)
                                       for n, a in zip(range(1, 5), aggs)])
        out[where] = [keys.sk_hat, keys.vk, sigs.sig, *aggs], verdicts, many
    for a, b in zip(out[dev][0], out["cpu"][0]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert out[dev][1:] == out["cpu"][1:]
    assert out["cpu"][1] == [(True, "")] * 4 and out["cpu"][2] == [(True, "")] * 4


def test_card_paths_run_no_plain_ntt(dev, monkeypatch):
    """With the plain NTTs, the plain aggregate check and the plain spec
    assembly made to fail, the fleet build, the grouped verify (both
    assemblies) and the lifecycle still run on the card: every NTT, every
    aggregate check and every spec assembly there is a kernel."""
    from fusion_cryptography_tpu_torch.ops import intt_norm_weight as inw
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    def plain_ntt(*args, **kwargs):
        raise AssertionError("a plain NTT ran on a card path")

    for name in ("ntt_fwd_u_plain", "ntt_inv_u_plain", "ntt_fwd_plain", "ntt_inv_plain"):
        monkeypatch.setattr(ntt, name, plain_ntt)
    monkeypatch.setattr(inw, "ntt_inv_u_plain", plain_ntt)
    monkeypatch.setattr(inw, "agg_check_plain", plain_ntt)
    monkeypatch.setattr(ds, "assemble_chunks_words", plain_ntt)
    params = fusion_setup(256, 3)
    vks, msgs, aggs = build_fleet(params, 3, 4, seed0=9, device=dev)
    assert all(bool(t.all()) for t in dp.verify_batch_device(params, vks, msgs, aggs))
    before = kernels.LAUNCHES["assemble_spec"]
    v2, m2, a2 = build_fleet(params, 3, 4, seed0=9, device=dev, assembly="spec")
    assert torch.equal(v2, vks) and m2 == msgs and torch.equal(a2, aggs)
    assert all(bool(t.all()) for t in dp.verify_batch_device(params, vks, msgs, aggs,
                                                              assembly="spec"))
    assert kernels.LAUNCHES["assemble_spec"] == before + 4
    _, _, _, cc, al = dp.derive_coeffs_device(params, vks, msgs, aggs)
    assert all(bool(t.all()) for t in lc.verify_batch(params, vks, cc, al, aggs))
    keys = lc.keygen(params, [9, 10, 11, 12], device=dev)
    m = ["w", "x", "y", "z"]
    sigs = lc.sign(params, keys, m)
    agg = lc.aggregate(params, keys.vk, m, sigs.sig)
    assert lc.verify(params, keys.vk, m, agg) == (True, "")
    assert lc.verify_many(params, [(keys.vk, m, agg)]) == [(True, "")]
