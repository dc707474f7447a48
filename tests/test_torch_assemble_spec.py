"""The generic spec assembler (ops/assemble_spec.py) on the CPU, its plain
version, vs the JAX package's TPU kernel 8 (ops/assemble_pallas.py,
``output="words"``) in interpret mode, as tests/test_keccak_assemble_pallas.py
runs it, and vs the JAX word assembler ``assemble_chunks_words``; and the op
table of a spec (``device_serial.spec_table``) vs the fold kernels' tables
where their programs coincide.  The kernel itself is held against this plain
version by tests/test_torch_kernel_host.py (g++) and, on the card,
tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import device_serial as jds
from fusion_cryptography_tpu.ops.assemble_pallas import assemble_pallas
from fusion_cryptography_tpu_torch import params_from_numpy
from fusion_cryptography_tpu_torch.interop import device_serial as ds
from fusion_cryptography_tpu_torch.ops import ragged_words as rw
from fusion_cryptography_tpu_torch.ops.assemble_spec import assemble_spec

PRE_BYTES = 4 * rw.words_for(ds.PREHASH_W)  # 80


def _i32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _inputs(params, B, seed):
    """Centered values int32[3d, B] with 0, +-1 and +-(q-1)/2 among them;
    prehash digits as bytes uint8[80, B] and words int32[20, B], lengths
    0..78 with 0 and 78 present."""
    d, q = params.degree, params.modulus
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(q // 2), q // 2 + 1, (3 * d, B), dtype=np.int64)
    vals[:5, 0] = [0, 1, -1, q // 2, -(q // 2)]
    vals[:, 1] = 0
    vals[:, 2] = -(q // 2)
    vals = vals.astype(np.int32)
    lens = rng.integers(0, ds.PREHASH_W + 1, B).astype(np.int32)
    lens[:3] = [0, ds.PREHASH_W, 1]
    by = rng.integers(ord("0"), ord("9") + 1, (PRE_BYTES, B), dtype=np.uint8)
    by[np.arange(PRE_BYTES)[:, None] >= lens[None, :]] = 0
    words = np.ascontiguousarray(by.T).view(np.int32).T.copy()
    return vals, by, words, lens


@pytest.fixture(scope="module")
def lane128():
    jp = ftpu.fusion_setup(128, 5)
    return jp, params_from_numpy(jp), _inputs(jp, 128, 3)


def _jax_words(spec, values, extras, bounds, pad_to):
    buf, tot = assemble_pallas(spec, values=values, extras=extras, extra_bounds=bounds,
                               pad_to=pad_to, output="words", interpret=True)
    return _i32(buf), np.asarray(tot)


def test_challenge_and_triple_specs_match_jax_kernel(lane128):
    """B = 128 lanes at secpar=128: the rate-padded challenge preimage and
    the triple, prehash extras of 0..78 bytes."""
    jp, p, (vals, by, words, lens) = lane128
    d = jp.degree
    jex = [(jnp.asarray(by[: ds.PREHASH_W].astype(np.int32)), jnp.asarray(lens))]
    tex = [(torch.from_numpy(words), torch.from_numpy(lens))]
    bounds = [(0, ds.PREHASH_W)]
    ch_w = ds.signer_fold_a_table(p).widths[0]
    want = _jax_words(jds.challenge_preimage_spec(jp), jnp.asarray(vals[: 2 * d]), jex, bounds,
                      4 * ch_w)
    got = assemble_spec(ds.challenge_preimage_spec(p), torch.from_numpy(vals[: 2 * d]), tex,
                        bounds, ch_w)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # lane 1 renders every value as "0": the shortest body, with 78 digits
    assert int(got[1][1]) == ds.spec_min_total(ds.challenge_preimage_spec(p), [ds.PREHASH_W])
    want = _jax_words(jds.triple_spec(jp), jnp.asarray(vals), jex, bounds, 0)
    got = assemble_spec(ds.triple_spec(p), torch.from_numpy(vals), tex, bounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_aggregation_spec_matches_jax_kernel(lane128):
    """An extras-only program: N = 2 triples per lane (the batch's triples
    and the same rolled by one lane), as byte rows for the JAX kernel and as
    strided word views of one buffer for the port."""
    jp, p, (vals, _, words, lens) = lane128
    N, B = 2, vals.shape[1]
    tri = ds.triple_spec(p)
    tb, tl = assemble_spec(tri, torch.from_numpy(vals), [(torch.from_numpy(words),
                                                          torch.from_numpy(lens))])
    both = torch.stack([tb, torch.roll(tb, 1, dims=1)], dim=-1)  # [W, B, N]
    both_len = torch.stack([tl, torch.roll(tl, 1)], dim=-1)
    extras = [(both[:, :, k], both_len[:, k]) for k in range(N)]
    spec = ds.agg_preimage_spec(p, N, tri.out_max)
    bounds = [(ds.spec_min_total(tri, [0]), tri.out_max)] * N
    got = assemble_spec(spec, None, extras, bounds)
    tri_bytes = rw.unpack_words_to_bytes(both.permute(2, 0, 1).contiguous(), tri.out_max)
    jex = [(jnp.asarray(tri_bytes[k].numpy().astype(np.int32)), jnp.asarray(both_len[:, k].numpy()))
           for k in range(N)]
    want = _jax_words(jds.agg_preimage_spec(jp, N, jds.triple_spec(jp).out_max), None, jex,
                      bounds, 0)
    assert got[0].shape == (rw.words_for(spec.out_max), B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_aggregation_spec_matches_jax_word_assembler_256():
    """secpar=256 (d = 256), an extras-only program over N = 3 strided
    triple views, against the JAX package's XLA word assembler.  (Its
    challenge and triple specs take minutes to compile there on the CPU;
    at 256 they are held to JAX end to end by the "spec" configuration's
    coefficients in tests/test_torch_pipeline.py.)"""
    jp = ftpu.fusion_setup(256, 8)
    p = params_from_numpy(jp)
    B, N = 12, 3
    vals, _, words, lens = _inputs(jp, B, 256)
    tri = ds.triple_spec(p)
    tb, tl = assemble_spec(tri, torch.from_numpy(vals), [(torch.from_numpy(words),
                                                          torch.from_numpy(lens))])
    tb, tl = tb.reshape(tb.shape[0], B // N, N), tl.reshape(B // N, N)
    pad = ds.agg_fold_table(p, N).widths[0]
    got = assemble_spec(ds.agg_preimage_spec(p, N, tri.out_max), None,
                        [(tb[:, :, k], tl[:, k]) for k in range(N)], pad_words=pad)
    jex = [(jnp.asarray(tb[:, :, k].numpy().view(np.uint32)), jnp.asarray(tl[:, k].numpy()))
           for k in range(N)]
    want = jds.assemble_chunks_words(jds.agg_preimage_spec(jp, N, tri.out_max), values=None,
                                     extras=jex, pad_words=pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _i32(w))


def _program(table: ds.FoldTable, writer: int = 0) -> list:
    """The ops a writer runs, with consecutive consts merged into one byte
    string: [bytes | ("cells", sep, i0, count) | ("extra", e)]."""
    pool = table.pool.view(np.uint32).astype("<u4").tobytes()
    out: list = []
    for kind, mask, a0, a1, a2, a3 in table.ops.tolist():
        if not (mask >> writer) & 1:
            continue
        if kind == ds.OP_CONST:
            data = pool[4 * a0: 4 * a0 + a1]
            if out and isinstance(out[-1], bytes):
                out[-1] += data
            else:
                out.append(data)
        elif kind == ds.OP_CELLS:
            out.append(("cells", pool[4 * a0: 4 * a0 + a1], a2, a3))
        else:
            out.append(("extra", a0))
    return out


@pytest.mark.parametrize("secpar", [128, 256])
def test_spec_table_matches_fold_tables(secpar):
    p = params_from_numpy(ftpu.fusion_setup(secpar, 2))
    d = p.degree
    fold_a = ds.signer_fold_a_table(p)
    ch = ds.spec_table(ds.challenge_preimage_spec(p), fold_a.widths[0])
    assert ch.widths == (fold_a.widths[0],)
    assert _program(ch) == _program(fold_a, 0)  # writer 1: the challenge preimage
    vk = ds.spec_table(ds.vk_body_spec(p))
    assert vk.widths == (fold_a.widths[1],)
    assert _program(vk) == _program(fold_a, 1)  # writer 2: the str(vk) chunk
    # the aggregation preimage: the same table
    agg = ds.agg_fold_table(p, 3)
    spec_agg = ds.spec_table(ds.agg_preimage_spec(p, 3, ds.triple_spec(p).out_max), agg.widths[0])
    assert np.array_equal(agg.ops, spec_agg.ops) and np.array_equal(agg.pool, spec_agg.pool)
    assert agg.widths == spec_agg.widths
    # the triple: after its prehash extra the challenge body, whose values
    # are rows 2d.. of the triple spec and rows 0.. of signer_fold_b's
    tri = _program(ds.spec_table(ds.triple_spec(p)))
    fold_b = _program(ds.signer_fold_b_table(p))
    tail = fold_b[fold_b.index(("extra", 1)) + 1:]
    shifted = [(n[0], n[1], n[2] + 2 * d, n[3]) if isinstance(n, tuple) else n for n in tail]
    assert tri[tri.index(("extra", 0)) + 1:] == shifted
    assert ds.spec_table(ds.triple_spec(p)).widths == ds.signer_fold_b_table(p).widths


def test_assemble_spec_checks_its_arguments(lane128):
    _, p, (vals, _, words, lens) = lane128
    tri = ds.triple_spec(p)
    ex = [(torch.from_numpy(words), torch.from_numpy(lens))]
    with pytest.raises(ValueError):  # one extra too many
        assemble_spec(tri, torch.from_numpy(vals), ex * 2)
    with pytest.raises(ValueError):  # values missing
        assemble_spec(tri, None, ex)
    with pytest.raises(ValueError):  # the wrong number of bounds
        assemble_spec(tri, torch.from_numpy(vals), ex, [(0, 1), (0, 1)])
