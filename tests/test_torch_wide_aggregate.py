"""Wide aggregates on the CPU: the port's grouped verify of groups of many
signers against the plain reference (``portbench/reference/fusion_ref.py``:
numpy and hashlib, held to ``KATs/reference_frozen/``), and the sort of a
group's keys by str(vk) that the fleet build, ``lifecycle.aggregate`` and
``verify_many`` rank signers with.  No JAX: the reference is the oracle."""
import numpy as np
import pytest
import torch

from fusion_cryptography_tpu_torch import fusion_setup
from fusion_cryptography_tpu_torch.interop import device_serial as ds
from fusion_cryptography_tpu_torch.ops import ragged_words as rw
from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
from fusion_cryptography_tpu_torch.scheme.device_setup import vk_sort_ranks
from portbench.reference import fusion_ref as ref

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def s256():
    return fusion_setup(256, 42), ref.setup(256, 42)


def test_port_verifies_reference_groups_of_64(s256):
    """Three groups of 64 signers that the reference made (keygen, sign,
    aggregate): group 0 with one message changed, group 1 as made, group 2
    with one aggregate coefficient changed.  The port's verdicts equal the
    reference verify's, and its challenges and alphas (after the NTT) the
    reference's ``challenges`` and ``alphas``."""
    params, rp = s256
    G, N, q = 3, 64, rp.modulus
    seeds = [[7001 + 2 * (g * N + k) for k in range(N)] for g in range(G)]
    texts = [[f"block {g} transaction {k}: {'x' * (k % 23)}" for k in range(N)] for g in range(G)]
    vks, msgs, aggs = ref.make_groups(rp, seeds, texts)
    msgs[0][17] = msgs[0][17][:-1] + "?"
    aggs[2, 5, 100] = (aggs[2, 5, 100] + 1 + q // 2) % q - q // 2
    want = ref.verify_groups(rp, vks, msgs, aggs)
    assert want[:, 0].tolist() == [False, True, False] and want[:2, 1:].all()

    flat = [m for group in msgs for m in group]
    eq, norm_ok, weight_ok, cc, al = dp.derive_coeffs_device(
        params, torch.as_tensor(vks, dtype=torch.int32), flat,
        torch.as_tensor(aggs, dtype=torch.int32), device=CPU)
    np.testing.assert_array_equal(torch.stack([eq, norm_ok, weight_ok], 1).numpy(), want)

    strs = [ref.vk_str(rp, v) for v in vks.reshape(G * N, 2, -1)]
    pre = [ref.prehash(rp, m) for m in flat]
    c_hat = ref.challenges(rp, strs, pre)
    np.testing.assert_array_equal(ref.ntt(rp, cc.reshape(G * N, -1).numpy().astype(np.int64)),
                                  c_hat)
    np.testing.assert_array_equal(ref.ntt(rp, al.numpy().astype(np.int64)),
                                  ref.alphas(rp, strs, pre, c_hat, N))


def _reference_ranks(rp, vks: np.ndarray) -> np.ndarray:
    """Each key's position under the reference's stable ``sorted`` by
    str(vk), group by group: vks int[G, N, 2, d] -> int[G, N]."""
    out = np.empty(vks.shape[:2], np.int64)
    for g, group in enumerate(vks):
        strs = [ref.vk_str(rp, v) for v in group]
        out[g, sorted(range(len(group)), key=lambda k: strs[k])] = np.arange(len(group))
    return out


def _edge_keys(q: int, G: int, N: int, d: int, seed: int) -> np.ndarray:
    """Random centered keys int32[G, N, 2, d] with repeats and near
    repeats: in each group a key twice and three times, keys that differ
    only in the last number (1234, 1235, 12340), keys whose
    first numbers are prefixes of one another ("5", "50", "-5", "0",
    "12") and int32's extremes."""
    rng = np.random.default_rng(seed)
    vks = rng.integers(-(q // 2), q // 2 + 1, (G, N, 2, d)).astype(np.int32)
    for group in vks:
        group[1] = group[0]
        group[2] = group[0]
        group[N - 1] = group[0]
        group[4, 1, d - 1] = 1234
        group[3] = group[4]
        group[3, 1, d - 1] = 1235
        group[5] = group[4]
        group[5, 1, d - 1] = 12340
        group[6:11, 0, 0] = [5, 50, -5, 0, 12]
        group[11, 0, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return vks


@pytest.mark.parametrize("G,N", [(1, 256), (3, 40)])
def test_vk_sort_ranks_equal_the_reference_sort(s256, G, N):
    """At N = 256 (and three groups of 40) the ranks are the positions
    under the reference's stable ``sorted(str(vk))``, duplicates in their
    original order."""
    params, rp = s256
    vks = _edge_keys(rp.modulus, G, N, params.degree, N)
    got = vk_sort_ranks(params, torch.from_numpy(vks.reshape(G * N, 2, -1)), N)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _reference_ranks(rp, vks))


def _pairwise_ranks(params, vk: torch.Tensor, N: int) -> torch.Tensor:
    """The pairwise comparison that ranked keys before the sort: each pair
    of a group ordered at its first differing byte of the 12-byte keys
    ``str(v) ++ terminator``, ties in their original order."""
    d, B = params.degree, vk.shape[0]
    G = B // N
    terms = torch.as_tensor(ds.number_terminators(ds.vk_body_spec(params)))
    chars, length = rw.decimal_chars(vk.reshape(B, 2 * d))
    keys = torch.nn.functional.pad(chars, (0, 1))
    keys.scatter_(2, length.unsqueeze(-1), terms.view(1, 2 * d, 1).expand(B, 2 * d, 1))
    keys = keys.reshape(G, N, 2 * d * 12)
    rank = torch.zeros((G, N), dtype=torch.int32)
    for i in range(N):
        for j in range(i + 1, N):
            ki, kj = keys[:, i], keys[:, j]
            first = (ki != kj).to(torch.uint8).argmax(dim=1, keepdim=True)
            i_first = (torch.gather(ki, 1, first) <= torch.gather(kj, 1, first)).squeeze(1)
            rank[:, j] += i_first.to(torch.int32)
            rank[:, i] += (~i_first).to(torch.int32)
    return rank


@pytest.mark.parametrize("secpar,N", [(128, 1), (128, 2), (256, 12), (256, 16)])
def test_vk_sort_ranks_equal_the_pairwise_ranks(secpar, N):
    """The sort gives the pairwise comparison's ranks at N <= 16, over five
    groups of keys with repeats and keys that differ only at their ends."""
    params = fusion_setup(secpar, 3)
    if N >= 12:
        vks = _edge_keys(params.modulus, 5, N, params.degree, secpar + N)
    else:
        rng = np.random.default_rng(N)
        q = params.modulus
        vks = rng.integers(-(q // 2), q // 2 + 1, (5, N, 2, params.degree)).astype(np.int32)
        vks[1] = vks[0]
    vk = torch.from_numpy(vks.reshape(5 * N, 2, -1))
    assert torch.equal(vk_sort_ranks(params, vk, N), _pairwise_ranks(params, vk, N))
