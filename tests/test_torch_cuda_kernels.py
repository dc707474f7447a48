"""The port's CUDA kernels, compiled, vs their plain torch versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc (sm_90a) and skip
without one.  Run on the GPU machine (which has no JAX, hence no conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``."""
from collections import Counter
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
from fusion_cryptography_tpu_torch.ops import place_preimages as pp
from fusion_cryptography_tpu_torch.ops import sample_short as ss
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


@pytest.mark.parametrize("B", [1, 17, 31, 33, 8197])
def test_absorb_kernel_any_batch_and_counts(dev, B):
    """Kernel ``keccak_absorb`` at one, two and 32 threads (a warp) per
    sponge and through the wrapper, against the plain absorb exactly, on random words
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
        for team in (1, 2, 32):
            state = torch.full((50, B), -1, dtype=torch.int32, device=dev)
            assert ks._absorb_launch(words, nb, team, state) is state
            assert torch.equal(state, want)
        assert torch.equal(ks.absorb(words, nb), want)


@pytest.mark.parametrize("B", [1, 17, 31, 33, 8192 + 3])
def test_squeeze_kernel_both_teams(dev, B):
    """Kernel ``keccak_squeeze`` at one, two and 32 threads (a warp) per
    sponge and through the wrapper == the plain squeeze, into words pre-filled with -1,
    on random states: one rate block or less (1, 8, 34 words), a partial
    last block (35, 300), whole blocks (68), and the widths of a verify
    call's challenge (2,106) and aggregation (3,968) squeezes."""
    rng = np.random.default_rng(B + 7)
    state = torch.from_numpy(rng.integers(-(2**31), 2**31, (50, B),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    for n_words in (1, 8, 34, 35, 68, 300, 2106, 3968):
        want = keccak.shake256_squeeze_words(state, n_words)
        for team in (1, 2, 32):
            out = torch.full((n_words, B), -1, dtype=torch.int32, device=dev)
            assert ks._squeeze_launch(state, n_words, team, out) is out
            assert torch.equal(out, want)
        assert torch.equal(ks.squeeze(state, n_words), want)
    for team in (3, 16, 64):  # no such team: the launch is refused
        with pytest.raises(RuntimeError):
            ks._squeeze_launch(state, 8, team)
        with pytest.raises(RuntimeError):
            ks._absorb_launch(torch.zeros((34, B), dtype=torch.int32, device=dev),
                              torch.ones(B, dtype=torch.int32, device=dev), team)


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
    flat = torch.empty(aggs.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(aggs.shape)  # not on a 16-byte boundary: copied first
    off.copy_(aggs)
    got = agg_check(plan, agg_table(plan.field, pub, dev), off)
    assert off.data_ptr() % 16 and all(torch.equal(g, w) for g, w in zip(got, want))


NTT_ROOTS = {64: (Q, 23584283), 128: (Q, 128339038), 256: (Q, 3337519),
             512: (2013265921, 341742893), 1024: (2013265921, 1340477990)}


@pytest.mark.parametrize("d,rows", [(64, 333), (256, 1001), (64, 1001), (256, 333),
                                    (64, 1), (64, 4), (256, 1), (256, 4),
                                    (128, 1), (128, 4), (128, 333), (512, 1), (512, 4),
                                    (512, 333), (1024, 1), (1024, 4), (1024, 333)])
def test_ntt_kernels_match_plain(dev, d, rows):
    """Both kernels, both directions, each into an output filled with -1 (an
    unwritten word fails): residues with rows of 0 and q-1, centered values
    with 0, +-1 and +-(q-1)/2; row counts of 1, 4 and ones that are no
    multiple of a block's rows."""
    q, root = NTT_ROOTS[d]
    plan = make_plan(q, d, root)
    g = torch.Generator(device=dev).manual_seed(rows + d)
    u = torch.randint(0, q, (rows, d), dtype=torch.int64, device=dev, generator=g)
    u[-1] = 0
    u[0, :3] = torch.tensor([0, 1, q - 1])
    u[1:2] = q - 1
    c = (torch.randint(0, q, (rows, d), dtype=torch.int64, device=dev, generator=g)
         - q // 2).to(torch.int32)
    c[0, :5] = torch.tensor([0, 1, -1, q // 2, -(q // 2)], dtype=torch.int32)
    c[1:2] = -(q // 2)

    def launch(x, inverse):
        return ntt._launch(plan, x, inverse, x.dtype == torch.int32, torch.full_like(x, -1))

    before = dict(kernels.LAUNCHES)
    pairs = [(launch(u, False), ntt.ntt_fwd_u_plain(plan, u)),
             (launch(u, True), ntt.ntt_inv_u_plain(plan, u)),
             (launch(c, False), ntt.ntt_fwd_plain(plan, c)),
             (launch(c, True), ntt.ntt_inv_plain(plan, c))]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ntt_u"] == before.get("ntt_u", 0) + 2
    assert kernels.LAUNCHES["ntt_centered"] == before.get("ntt_centered", 0) + 2
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ntt.ntt_inv_u(plan, pairs[0][0]), u)
    assert torch.equal(ntt.ntt_inv(plan, pairs[2][0]), c)
    lead = c[:15].reshape(-1, 1, d)  # any leading shape
    assert torch.equal(ntt.ntt_fwd(plan, lead), pairs[2][0][:15].reshape(-1, 1, d))
    flat = torch.empty(rows * d + 1, dtype=torch.int64, device=dev)
    off = flat[1:].view(rows, d)  # rows not on a 16-byte boundary: copied first
    off.copy_(u)
    assert off.data_ptr() % 16 and torch.equal(ntt.ntt_fwd_u(plan, off), pairs[0][0])


def test_wrappers_check_their_inputs(dev):
    plan = make_plan(Q, 256, 3337519)
    with pytest.raises(ValueError):  # residues as int32
        ntt.ntt_fwd_u(plan, torch.zeros((4, 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # centered values as int64
        ntt.ntt_fwd(plan, torch.zeros((4, 256), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # trailing axis is not the degree
        ntt.ntt_inv_u(plan, torch.zeros((4, 64), dtype=torch.int64, device=dev))
    x = torch.zeros((4, 256), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):  # output of another type
        ntt._launch(plan, x, False, False, torch.zeros((4, 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # output of another shape
        ntt._launch(plan, x, False, False, torch.zeros((2, 512), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # output not on a 16-byte boundary
        ntt._launch(plan, x, False, False,
                    torch.zeros(4 * 256 + 1, dtype=torch.int64, device=dev)[1:].view(4, 256))
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
    with pytest.raises(ValueError):  # lengths of other groups than the triples'
        tri = torch.zeros((801, 2, B), dtype=torch.int32, device=dev)
        pf.agg_fold(params, 2, tri, pre_len.view(1, B).expand(2, B)[:, 1:])


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
    tb = got_b[0][:, : G * N].view(-1, G, N).transpose(1, 2)  # group-major lanes
    tl = got_b[1][: G * N].view(G, N).t()
    got_g = pf.agg_fold(params, N, tb, tl)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] == before.get(k, 0) + 1
               for k in ("signer_fold_a", "signer_fold_b", "agg_fold"))
    want_a = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    want_b = pf.signer_fold_b_plain(params, want_a[2], want_a[3], pre_w, pre_len, c_hat_t)
    want_g = pf.agg_fold_plain(params, N, want_b[0][:, : G * N].view(-1, G, N).transpose(1, 2),
                               want_b[1][: G * N].view(G, N).t())
    for got, want in zip((*got_a, *got_b, *got_g), (*want_a, *want_b, *want_g)):
        assert torch.equal(got, want)
    # the same triples signer-major, copied into a buffer of their own
    got_c = pf.agg_fold(params, N, tb.contiguous(), tl.contiguous())
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
    tbuf, tlen = agg_triples(params, G, N, secpar + 10 * N + G, signer_major, device=dev)
    before = kernels.LAUNCHES["agg_fold"]
    got = pf.agg_fold(params, N, tbuf, tlen)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["agg_fold"] == before + 1
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
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


@pytest.mark.parametrize("assembly", ["fold", "spec"])
def test_windowed_verify_makes_no_host_sync(dev, assembly):
    """A windowed verify call (signer chunks of 2 groups, group windows of
    4) with its inputs on the card and the messages a list waits for the
    device nowhere between its entry and its return, and gives the
    one-chunk call's verdicts; its coefficients equal the one-chunk ones."""
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params = fusion_setup(128, 5)
    vks, msgs, aggs = build_fleet(params, 7, 2, seed0=21, device=dev)
    bad = aggs.clone()
    bad[6, 0, 0] = (bad[6, 0, 0] + 1) % Q
    want = dp.verify_batch_device(params, vks, msgs, bad, assembly=assembly)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dp.verify_batch_device(params, vks, msgs, bad, group_chunk=2, group_hash_chunk=4,
                                     assembly=assembly)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].tolist() == [True] * 6 + [False]
    one = dp.derive_coeffs_device(params, vks, msgs, bad, assembly=assembly)
    two = dp.derive_coeffs_device(params, vks, msgs, bad, group_chunk=3, assembly=assembly)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    # 3 groups of N = 1,024 at secpar 256 (agg_fold's prefix launch, the split
    # lattice check), signer chunks of one group joined into windows of two
    p256 = fusion_setup(256, 5)
    vks, msgs, aggs = build_fleet(p256, 3, 1024, seed0=77, device=dev)
    aggs[1, 0, 0] = (aggs[1, 0, 0] + 1) % Q
    want = dp.verify_batch_device(p256, vks, msgs, aggs, assembly=assembly)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dp.verify_batch_device(p256, vks, msgs, aggs, group_chunk=1, group_hash_chunk=2,
                                     assembly=assembly)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].tolist() == [True, False, True]


def test_keygen_and_sign_make_no_host_sync(dev):
    """lifecycle.keygen then lifecycle.sign of 64 keys wait for the device
    nowhere between their entry and their return (the sampled coefficients
    go up from pinned memory, and A's sum is built once per device), and
    give the bits of the same calls made before the check."""
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    params = fusion_setup(128, 5)
    seeds, msgs = list(range(100, 228, 2)), [f"key {i}" for i in range(64)]
    want_keys = lc.keygen(params, seeds, device=dev)
    want = lc.sign(params, want_keys, msgs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keys = lc.keygen(params, seeds, device=dev)
        sigs = lc.sign(params, keys, msgs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(keys.sk_hat, want_keys.sk_hat) and torch.equal(keys.vk, want_keys.vk)
    assert torch.equal(sigs.sig, want.sig)


def _random_words(dev, W, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(2**31), 2**31, (W, L), dtype=torch.int64, device=dev,
                         generator=g).to(torch.int32)


@pytest.mark.parametrize("secpar", [128, 256])
def test_xof_decode_kernel_matches_plain(dev, secpar):
    """Kernel ``xof_decode`` == ``decode_rows_plain`` exactly (the plain
    version on the same card tensors, and on the CPU): challenge streams at
    the pipeline's length, cut inside an index row and at min_bytes; alpha
    streams alone and as the group stage's blob of 3 and 4 streams a lane
    (1,195 bytes apart at secpar=128: unaligned); 1, 37 and 4,100 lanes."""
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    g = dp._geometries(fusion_setup(secpar, 1))
    gc, ga = g["geom_ch"], g["geom_ag"]
    n_ch, n_ag = g["n_xof_ch_used"], g["block_ag"]
    cases = [(gc, n_ch, 1), (gc, n_ch - 13, 1), (gc, gc.min_bytes, 1), (ga, n_ag, 1),
             (ga, n_ag, 3), (ga, n_ag, 4)]
    before = kernels.LAUNCHES["xof_decode"]
    for i, (geom, n, ns) in enumerate(cases):
        for L in (1, 37, 4100):
            words = _random_words(dev, -(-ns * n // 4) + 1, L, 100 * i + L)
            got = xd.decode_coeffs_rows(words, geom, n, ns)
            want = xd.decode_rows_plain(words, geom, n, ns)
            assert got.dtype == torch.int32 and torch.equal(got, want), (i, L)
            if L == 37:
                assert torch.equal(got.cpu(), xd.decode_coeffs_rows(words.cpu(), geom, n, ns))
                if ns == 1:
                    assert torch.equal(xd.decode_coeffs_w(words, geom, n), want.t())
    assert kernels.LAUNCHES["xof_decode"] == before + 3 * len(cases) + sum(c[2] == 1 for c in cases)
    magnitudes = xd.geometry(128, Q, 64, 5, 27)  # bound 5: the int32 tile
    n = magnitudes.min_bytes + 41
    for ns in (1, 2):
        words = _random_words(dev, -(-ns * n // 4), 333, ns)
        got = xd.decode_coeffs_rows(words, magnitudes, n, ns)
        assert torch.equal(got, xd.decode_rows_plain(words, magnitudes, n, ns))
        assert int(got.abs().max()) > 1


@pytest.mark.parametrize("secpar", [128, 256])
def test_xof_decode_kernel_crafted_placement(dev, secpar):
    """Kernel ``xof_decode`` == ``decode_rows_plain`` exactly on crafted
    streams (``xof_decode.crafted_streams``: first hits on the first and last
    rows of the warps' shares, one slot hit in every share, every slot or
    none hit, slot 0 hit or not before the rows past the end), at the
    challenge and alpha geometries, alone and as the blob of 3 and 4
    streams a lane; 333 and 4,100 lanes."""
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    g = dp._geometries(fusion_setup(secpar, 1))
    gc, ga = g["geom_ch"], g["geom_ag"]
    cases = [(gc, g["n_xof_ch_used"], 1), (gc, gc.min_bytes, 1), (ga, g["block_ag"], 1),
             (ga, g["block_ag"], 3 if secpar == 128 else 4)]
    for geom, n, ns in cases:
        for L in (333, 4100):
            words = torch.from_numpy(xd.crafted_streams(geom, n, ns, L, seed=L + n).view(
                np.int32)).to(dev)
            got = xd.decode_coeffs_rows(words, geom, n, ns)
            assert torch.equal(got, xd.decode_rows_plain(words, geom, n, ns)), (n, ns, L)


def test_xof_decode_kernel_wide_moduli(dev):
    """Kernel ``xof_decode`` == ``decode_rows_plain`` exactly where a
    modulus is above 256 (a bound of 70,000: the power table in three byte
    planes), one and two streams a lane (unaligned), 1 and 333 lanes."""
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd

    geom = xd.geometry(128, Q, 64, 70000, 27)
    assert xd._planes(geom) == 3
    n = geom.min_bytes + 23
    for ns in (1, 2):
        for L in (1, 333):
            words = _random_words(dev, -(-ns * n // 4) + 1, L, 7 * ns + L)
            got = xd.decode_coeffs_rows(words, geom, n, ns)
            assert torch.equal(got, xd.decode_rows_plain(words, geom, n, ns)), (ns, L)
            assert int(got.abs().max()) > 256


def test_render_prehash_kernel_chunk_edges(dev):
    """Kernel ``render_prehash`` == ``render_bigint_dec_plain`` and str()
    on digests whose base-10^9 chunks are zero in the middle (10^72 + 1,
    10^36, 10^45 + 10^9 - 1) or all nines (2^256 - 1, 10^77 - 1, 10^72 -
    1), and each power of ten and its predecessor up to 10^77."""
    edges = [10**72 + 1, 10**36, 10**45 + 10**9 - 1, 2**256 - 1, 10**77 - 1, 10**72 - 1]
    edges += [10**e + o for e in range(78) for o in (-1, 0)]
    B = len(edges)
    d = torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in edges],
                     dtype=torch.int64).t().to(torch.int32).contiguous().to(dev)
    got = rw.render_bigint_dec_w(d)
    want = rw.render_bigint_dec_plain(d)
    assert torch.equal(got.buf, want.buf) and torch.equal(got.length, want.length)
    by = got.buf.t().contiguous().view(torch.uint8).cpu().numpy()
    lens = got.length.cpu().numpy()
    for b, v in enumerate(edges):
        s = str(v).encode()
        assert lens[b] == len(s) and by[b, :len(s)].tobytes() == s and not by[b, len(s):].any()


def test_render_prehash_kernel_matches_plain(dev):
    """Kernel ``render_prehash`` == ``render_bigint_dec_plain`` exactly
    (words and lengths), on random digests and the edges 0, 10^9 - 1,
    10^9, 10^72, 10^77 - 1, 10^77, 2^256 - 1, at 1, 300 and 70,001 lanes;
    its words on memory never zeroed first."""
    edges = [0, 7, 10**9 - 1, 10**9, 10**72, 10**77 - 1, 10**77, 2**256 - 1]
    ew = torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in edges],
                      dtype=torch.int64).t().to(torch.int32)
    before = kernels.LAUNCHES["render_prehash"]
    for B in (1, 300, 70001):
        d = _random_words(dev, 8, B, B)
        d[:, : min(B, len(edges))] = ew[:, : min(B, len(edges))].to(dev)
        got = rw.render_bigint_dec_w(d)
        want = rw.render_bigint_dec_plain(d)
        assert torch.equal(got.buf, want.buf) and torch.equal(got.length, want.length)
        assert (got.max_len, got.min_len) == (want.max_len, want.min_len)
        if B == 300:
            cpu = rw.render_bigint_dec_w(d.cpu())
            assert torch.equal(got.buf.cpu(), cpu.buf) and torch.equal(got.length.cpu(), cpu.length)
    assert kernels.LAUNCHES["render_prehash"] == before + 3


@pytest.mark.parametrize("secpar,N", [(128, 3), (256, 4)])
def test_lattice_target_kernel_matches_plain(dev, secpar, N):
    """Kernel ``lattice_target`` == ``lattice_target_plain`` exactly: observed
    equal to the target but in one group, a norm breach and a weight breach
    in two others, limits met exactly in two more, vk edge values; 1, 37 and
    9,000 groups."""
    from fusion_cryptography_tpu_torch.ops.field import get_field
    from fusion_cryptography_tpu_torch.ops.lattice_target import (
        lattice_target, lattice_target_plain)

    params = fusion_setup(secpar, 1)
    q, d, rank = params.modulus, params.degree, params.rank
    beta, omega = min(params.beta_vf, 2**31 - 1), params.omega_vf
    F = get_field(q)
    before = kernels.LAUNCHES["lattice_target"]
    for G in (1, 37, 9000):
        gen = torch.Generator(device=dev).manual_seed(G)

        def rnd(lo, hi, shape, dtype=torch.int64):
            return torch.randint(lo, hi, shape, dtype=torch.int64, device=dev,
                                 generator=gen).to(dtype)

        vks = rnd(-(q // 2), q // 2 + 1, (G, N, 2, d), torch.int32)
        vks[0, 0, 0, :5] = torch.tensor([0, 1, -1, q // 2, -(q // 2)], dtype=torch.int32)
        c, a = rnd(0, q, (G, N, d)), rnd(0, q, (G, N, d))
        nrm, wgt = rnd(0, beta + 1, (G, rank), torch.int32), rnd(0, omega + 1, (G, rank),
                                                                  torch.int32)
        vk_u = F.to_unsigned(vks)
        t = F.add_mod(F.mont_mul(F.to_mont(c), vk_u[..., 0, :]), vk_u[..., 1, :])
        observed = F.sum_mod(F.mont_mul(F.to_mont(a), t), axis=-2)
        if G > 5:
            observed[1, d // 2] = (observed[1, d // 2] + 1) % q
            nrm[2, -1], wgt[3, 0] = beta + 1, omega + 1
            nrm[4, 0], wgt[5, -1] = beta, omega
        got = lattice_target(F, vks, c, a, observed, nrm, wgt, beta, omega)
        want = lattice_target_plain(F, vks, c, a, observed, nrm, wgt, beta, omega)
        for x, y in zip(got, want):
            assert x.dtype == torch.bool and torch.equal(x, y)
        if G > 5:
            assert [torch.nonzero(~x).flatten().tolist() for x in got] == [[1], [2], [3]]
        else:
            assert all(bool(x.all()) for x in got)
    assert kernels.LAUNCHES["lattice_target"] == before + 3


@pytest.mark.parametrize("n_signers", [1, 4])
def test_place_preimages_kernel_matches_plain(dev, n_signers):
    """Kernel ``place_preimages`` == ``place_preimages_plain`` exactly (words,
    block counts, lengths; the plain version on the same card tensors and on
    the CPU), at 59-byte messages with the rate edges among them, at the
    nist traffic's 33 * k bytes, k = 1..100, and with multi-byte UTF-8 and
    NUL characters, in both lane orders."""
    rng = np.random.default_rng(7)

    def text(n):
        return rng.integers(0x20, 0x7F, n, dtype=np.uint8).tobytes().decode()

    sets = {"short": [text(59) for _ in range(8188)] + [text(n) for n in (132, 133, 134, 269)],
            "nist": [text(33 * (1 + k % 100)) for k in range(400)],
            "utf8": ["é" * 70, "\x00", "", "\U0001F600" + text(130)] * 25}
    prefix = torch.tensor([5, 0, 44], dtype=torch.uint8)
    before = kernels.LAUNCHES["place_preimages"]
    for name, msgs in sets.items():
        data, lens, _ = pp.encode(msgs)
        buf = pp.stream_buffer(data, lens, pin=True).to(dev)
        offsets, stream = pp.split(buf, len(msgs))
        rows = pp.rows_for(3 + int(lens.max()))
        got = pp.place_preimages(prefix.to(dev), offsets, stream, n_signers, rows)
        want = pp.place_preimages_plain(prefix.to(dev), offsets, stream, n_signers, rows)
        cpu = pp.place_preimages(prefix, offsets.cpu(), stream.cpu(), n_signers, rows)
        for g, w, c in zip(got, want, cpu):
            assert torch.equal(g, w) and torch.equal(g.cpu(), c), name
    assert kernels.LAUNCHES["place_preimages"] == before + len(sets)


def test_message_tensors_one_pass_on_the_card(dev, monkeypatch):
    """``_message_tensors`` on the card, through the one-pass route into a
    pinned block, at the nist cell's shape (32,768 messages of 33 * k bytes,
    k = 1..100) on outputs filled with -1, equals the CPU plain route's words,
    block counts and lengths, for two calls in a row with different payloads
    and no wait between them (a reused pinned block is never read stale)."""
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    def filled(outs, shapes, device, dtype=torch.int32):
        if outs is None:
            outs = [torch.full(shape, -1, dtype=dtype, device=device) for shape in shapes]
        return outs

    params = fusion_setup(256, 3)
    rng = np.random.default_rng(25)
    sets = []
    for _ in range(2):
        k = rng.integers(1, 101, 32768)
        text = rng.integers(0x20, 0x7F, int(33 * k.sum()), dtype=np.uint8).tobytes().decode()
        ends = np.cumsum(33 * k)
        sets.append([text[e - 33 * n:e] for e, n in zip(ends.tolist(), k.tolist())])
    assert pp.direct_offsets(sets[0]) is not None
    monkeypatch.setattr(kernels, "outputs", filled)
    got = [dp._message_tensors(params, msgs, dev, 4) for msgs in sets]
    torch.cuda.synchronize()
    monkeypatch.setattr(pp, "direct_offsets", lambda messages: None)
    for msgs, g in zip(sets, got):
        want = dp._message_tensors(params, msgs, "cpu", 4)
        for x, y in zip(g, want):
            assert x.device == dev and torch.equal(x.cpu(), y)


def test_card_paths_run_no_plain_glue(dev, monkeypatch):
    """With the plain XOF decode, prehash render, lattice target and
    preimage placement made to fail, the fleet build, the grouped verify
    (both assemblies), the windowed verify and the lifecycle still run on
    the card: each of those stages there is its kernel, and each path
    launched all four."""
    from fusion_cryptography_tpu_torch.ops import lattice_target as lt
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    def plain(*args, **kwargs):
        raise AssertionError("a plain glue stage ran on a card path")

    for mod, name in ((xd, "decode_rows_plain"), (xd, "split_streams_w"),
                      (rw, "render_bigint_dec_plain"), (lt, "lattice_target_plain"),
                      (pp, "place_preimages_plain")):
        monkeypatch.setattr(mod, name, plain)
    names = ("xof_decode", "render_prehash", "lattice_target", "place_preimages")
    params = fusion_setup(128, 3)
    before = Counter(kernels.LAUNCHES)
    vks, msgs, aggs = build_fleet(params, 5, 4, seed0=9, device=dev)
    fleet = Counter(kernels.LAUNCHES) - before
    assert [fleet[k] for k in names] == [2, 1, 0, 1], fleet
    for assembly in ("fold", "spec"):
        before = Counter(kernels.LAUNCHES)
        assert all(bool(t.all()) for t in dp.verify_batch_device(params, vks, msgs, aggs,
                                                                  assembly=assembly))
        call = Counter(kernels.LAUNCHES) - before
        assert [call[k] for k in names] == [2, 1, 1, 1], (assembly, call)
    out = dp.verify_batch_device(params, vks, msgs, aggs, group_chunk=2, group_hash_chunk=2)
    assert all(bool(t.all()) for t in out)
    keys = lc.keygen(params, [9, 10, 11], device=dev)
    m = ["x", "y", "z"]
    sigs = lc.sign(params, keys, m)
    before = Counter(kernels.LAUNCHES)
    agg = lc.aggregate(params, keys.vk, m, sigs.sig)
    assert lc.verify(params, keys.vk, m, agg) == (True, "")
    assert all((Counter(kernels.LAUNCHES) - before)[k] > 0 for k in names)


@pytest.mark.parametrize("G,N", [(8192, 4), (32, 1024)], ids=["short", "wide"])
def test_agg_fold_and_lattice_target_at_the_cells_shapes(dev, G, N):
    """At the short cell's 8,192 groups of 4 and the wide cell's 32 groups of
    1,024 (secpar 256): kernel ``agg_fold`` on stand-in triples over their
    whole range (one signer-major buffer; with its prefix launch at N =
    1,024) == ``agg_fold_plain``, into outputs filled with -1; kernel
    ``lattice_target`` at ``lattice_split``'s slices (66 at the wide shape
    on an H100) and at one warp a group == ``lattice_target_plain``, its
    verdicts written over their negation, with a tampered target, a norm
    breach and a weight breach."""
    from test_torch_kernel_host import agg_triples

    from fusion_cryptography_tpu_torch.ops.field import get_field
    from fusion_cryptography_tpu_torch.ops.lattice_target import (
        _lattice_target_launch, lattice_split, lattice_target_plain)

    params = fusion_setup(256, 2)
    q, d, rank = params.modulus, params.degree, params.rank
    tbuf, tlen = agg_triples(params, G, N, G + N, True, device=dev)
    (agg_w,) = ds.agg_fold_table(params, N).widths
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
    outs = [torch.full((agg_w, G), -1, dtype=torch.int32, device=dev),
            torch.full((G,), -1, dtype=torch.int32, device=dev)]
    before = kernels.LAUNCHES["agg_fold"]
    got = pf._agg_fold_launch(params, N, tbuf, tlen, outs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["agg_fold"] == before + (2 if N > 15 else 1)
    assert got[0] is outs[0] and got[1] is outs[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del tbuf, tlen, want, got, outs

    beta, omega = min(params.beta_vf, 2**31 - 1), params.omega_vf
    F = get_field(q)
    gen = torch.Generator(device=dev).manual_seed(N)

    def rnd(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, dtype=torch.int64, device=dev,
                             generator=gen).to(dtype)

    vks = rnd(-(q // 2), q // 2 + 1, (G, N, 2, d), torch.int32)
    c, a = rnd(0, q, (G, N, d)), rnd(0, q, (G, N, d))
    nrm, wgt = rnd(0, beta + 1, (G, rank), torch.int32), rnd(0, omega + 1, (G, rank), torch.int32)
    vk_u = F.to_unsigned(vks)
    t = F.add_mod(F.mont_mul(F.to_mont(c), vk_u[..., 0, :]), vk_u[..., 1, :])
    observed = F.sum_mod(F.mont_mul(F.to_mont(a), t), axis=-2)
    observed[1, d - 1] = (observed[1, d - 1] + 1) % q
    nrm[2, -1], wgt[3, 0] = beta + 1, omega + 1
    args = (F, vks, c, a, observed, nrm, wgt, beta, omega)
    want = lattice_target_plain(*args)
    assert [torch.nonzero(~x).flatten().tolist() for x in want] == [[1], [2], [3]]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for slices in {lattice_split(G, N, sms), 1}:
        out = torch.stack([~x for x in want])
        got = _lattice_target_launch(*args, slices, out)
        for x, y in zip(got, want):
            assert x.dtype == torch.bool and torch.equal(x, y)
    assert (lattice_split(G, N, sms) > 1) == (N > 4)


# 2**32 - 1 + 1 takes two key words in CPython's seeding; 1,024 consecutive
# keys from below 2**32 to above it
SAMPLE_SEEDS = [0, 1, 42, 2**31, 2**32 - 1, 2**32, 2**63, 2**64 - 2] + \
    list(range(2**32 - 512, 2**32 + 512))


@pytest.mark.parametrize("degree,norm_bound,weight_bound", [(64, 52, 64), (256, 52, 60),
                                                            (256, 52, 256)])
def test_sample_short_kernel_matches_c_sampler_and_cpython(dev, degree, norm_bound,
                                                          weight_bound):
    """Kernel ``sample_short`` on an output filled with -1: key b's row 0
    from seed s, row 1 from s + 1, equal to the C sampler and to CPython's
    random at secpar 128's keys, a partial weight (the Fisher-Yates pass) and
    secpar 256's keys."""
    from fusion_cryptography_tpu_torch import native
    from fusion_cryptography_tpu_torch.hashing.sampler import sample_short_poly_coeffs

    seeds = np.array(SAMPLE_SEEDS, dtype=np.uint64)
    out = torch.full((len(seeds), 2, degree), -1, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["sample_short"]
    got = ss.sample_short(seeds, degree, norm_bound, weight_bound, Q, dev, out=out)
    assert got is out and kernels.LAUNCHES["sample_short"] == before + 1
    got = got.cpu().numpy().reshape(-1, degree)
    streams = [x for s in SAMPLE_SEEDS for x in (s, s + 1)]
    assert np.array_equal(got, native.sample_short_batch(streams, degree, norm_bound,
                                                         weight_bound, Q))
    want = np.stack([sample_short_poly_coeffs(Q, degree, norm_bound, weight_bound, s)
                     for s in streams])
    assert np.array_equal(got, want)


def test_sample_short_wrapper_checks_its_inputs(dev):
    seeds = np.arange(4, dtype=np.uint64)
    with pytest.raises(ValueError):  # int64 seeds
        ss.sample_short(seeds.astype(np.int64), 64, 52, 64, Q, dev)
    with pytest.raises(ValueError):  # seeds on the card
        ss.sample_short(torch.zeros(4, dtype=torch.int64, device=dev), 64, 52, 64, Q, dev)
    with pytest.raises(ValueError):  # s + 1 past 2**64
        ss.sample_short(np.array([2**64 - 1], dtype=np.uint64), 64, 52, 64, Q, dev)
    with pytest.raises(ValueError):  # an empty range for the magnitudes
        ss.sample_short(seeds, 64, 0, 64, Q, dev)
    with pytest.raises(ValueError):  # a bound past int32
        ss.sample_short(seeds, 64, 2**31, 64, Q, dev)
    with pytest.raises(ValueError):  # an output of another shape
        ss.sample_short(seeds, 64, 52, 64, Q, dev,
                        out=torch.zeros((4, 64), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # an output on the CPU
        ss.sample_short(seeds, 64, 52, 64, Q, dev, out=torch.zeros((4, 2, 64), dtype=torch.int32))


@pytest.mark.parametrize("secpar", [128, 256])
def test_card_keygen_samples_on_the_card(dev, secpar):
    """lifecycle.keygen of 1,024 keys on the card (kernel ``sample_short``)
    gives the CPU's sk_hat and vk, and leaves CPython's global random as
    the CPU keygen does."""
    import random

    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    params = fusion_setup(secpar, 3)
    seeds = list(range(2**32 - 1000, 2**32 + 1048, 2))
    before = kernels.LAUNCHES["sample_short"]
    random.seed(5)
    on_card = lc.keygen(params, seeds, device=dev)
    card_state = random.getstate()
    assert kernels.LAUNCHES["sample_short"] == before + 1
    random.seed(5)
    on_cpu = lc.keygen(params, seeds, device="cpu")
    assert random.getstate() == card_state
    assert torch.equal(on_card.sk_hat.cpu(), on_cpu.sk_hat)
    assert torch.equal(on_card.vk.cpu(), on_cpu.vk)
