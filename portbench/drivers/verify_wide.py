"""Driver of the grouped aggregate-verify over wide aggregates: the verify
driver (``drivers/verify.py``: the same set-up, calls and checks), whose
work count adds the two numbers the wide cell's per-layer metrics read.

* ``chain_perms``: the longest group's aggregation sponge in
  Keccak-f[1600] permutations, one after another whatever the kernel: the
  absorb of its preimage ``dst + "," + str(list(zip(...)))`` (its length
  from the call's keys, messages and challenges, as
  ``roofline.verify_work`` counts it) and the squeeze of N alpha blocks;
* ``target_bytes``: the least bytes of the lattice check's target half --
  the vks int32[G, N, 2, d], c_hat and alpha_hat [G, N, d] and the observed
  sum [G, d] as 4-byte residues, the rows' norms and weights int32[G,
  rank] in and three verdict bytes a group out.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench import core, roofline
from portbench.reference import fusion_ref as ref

_verify = core.load(Path(__file__).resolve().parent / "verify.py")


def agg_lengths(params: ref.Params, vks: np.ndarray, messages) -> np.ndarray:
    """int64[G]: each group's aggregation preimage in bytes, vks int[G, N,
    2, d] as the call takes them, the G*N messages in the same order."""
    G, N, _, d = vks.shape
    flat = np.asarray(vks, dtype=np.int64).reshape(G * N, 2, d)
    vk_strs = [ref.vk_str(params, v) for v in flat]
    pre = [ref.prehash(params, m) for m in messages]
    c_hat = ref.challenges(params, vk_strs, pre)
    vk_len = np.array([len(s) for s in vk_strs], dtype=np.int64)
    pre_len = np.array([len(str(i)) for i in pre], dtype=np.int64)
    ch_len = (len(ref.challenge_str(params, np.zeros(d, np.int64))) - d
              + roofline.str_lengths(c_hat))
    # "(" vk ", " prehash ", " challenge ")", joined by ", " inside "[" "]"
    triple = (vk_len + pre_len + ch_len + 6).reshape(G, N)
    return len(params.ag_dst) + 1 + 2 + triple.sum(axis=1) + 2 * (N - 1)


def chain_perms(params: ref.Params, vks: np.ndarray, messages) -> int:
    """Permutations of the longest group's aggregation sponge (arguments as
    :func:`agg_lengths`'): its absorb, then the squeeze of N alpha blocks."""
    return (roofline.absorb_perms([int(agg_lengths(params, vks, messages).max())])
            + roofline.squeeze_perms(vks.shape[1] * ref.agg_block_len(params), 1))


def target_bytes(params: ref.Params, groups: int, n_signers: int) -> int:
    d = params.degree
    return groups * (n_signers * (4 * 2 * d + 4 * d + 4 * d) + 4 * d + 2 * 4 * params.rank + 3)


class Driver(_verify.Driver):
    def work(self, i: int) -> dict:
        x = self.batches[i % len(self.batches)]
        if x.work is None:
            vks = x.vks.cpu().numpy()
            G, N = vks.shape[:2]
            x.work = {**roofline.verify_work(self.rp, vks, x.msgs),
                      "chain_perms": chain_perms(self.rp, vks, x.msgs),
                      "target_bytes": target_bytes(self.rp, G, N)}
        return x.work
