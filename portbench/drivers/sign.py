"""Driver of batched one-time signing: ``scheme/lifecycle.keygen`` then
``lifecycle.sign``, B fresh keys a call.

Call i generates the keys of seeds base + 2(iB + k) (a key takes its seed
and the next, so no two keys share a polynomial, and no key is ever used
twice) and signs message k of one of the traffic's message sets.  It ends
with the vks and signatures of ``check_keys_per_call`` keys, drawn from
the seed, on the host; the plain reference's keygen and sign of those keys
judge them after the window (``vk_mismatches``, ``signature_mismatches``):
the sampler, the keygen NTT, vk = A·sk, the prehash and signer stages and
the signature product.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as tf
from portbench.driver_base import Driver as Base
from portbench.driver_base import scheme_params
from portbench.reference import fusion_ref as ref

WARM_CALLS = 2
SAMPLE_TABLE = 65536  # calls before the sampled keys repeat their pattern
MAX_CHECKED = 512  # (call, key) pairs the reference recomputes


class Driver(Base):
    def setup(self) -> None:
        from fusion_cryptography_tpu_torch.scheme import device_setup, lifecycle

        c, t = self.config, self.traffic
        self.lc, self.ds = lifecycle, device_setup
        self.params, self.rp = scheme_params(c)
        B = c["batch"]
        self.msg_sets = [tf.messages(t, B, self.seed, s) for s in range(t["batches"])]
        self.base = tf.key_seed_base(self.seed, 0)
        self.samples = tf.key_samples(SAMPLE_TABLE, B, t["check_keys_per_call"], self.seed)
        warm_base = tf.key_seed_base(self.seed, 1)
        for w in range(WARM_CALLS):
            self._sign(warm_base, w, np.zeros(1, dtype=np.int64))
        self.kept = []

    def seeds(self, base: int, i: int):
        B = self.config["batch"]
        return range(base + 2 * i * B, base + 2 * (i + 1) * B, 2)

    def _sign(self, base: int, i: int, idx: np.ndarray):
        keys = self.lc.keygen(self.params, list(self.seeds(base, i)), device=self.device)
        sigs = self.lc.sign(self.params, keys, self.msg_sets[i % len(self.msg_sets)])
        at = torch.as_tensor(idx, device=keys.vk.device)
        with self.span("readback"):
            return keys.vk[at].cpu().numpy(), sigs.sig[at].cpu().numpy()

    def call(self, i: int) -> int:
        idx = self.samples[i % SAMPLE_TABLE]
        vk, sig = self._sign(self.base, i, idx)
        self.kept.append((i, idx, vk, sig))
        return self.config["batch"]

    def wraps(self):
        return ((self.ds, "_sample_sk", "host.sampler"),)

    def _pairs(self):
        """The (call, key, vk, signature) the reference recomputes, drawn from
        the seed among the kept ones."""
        pairs = [(i, j, vk[n], sig[n]) for i, idx, vk, sig in self.kept
                 for n, j in enumerate(idx.tolist())]
        pick = tf.rng(self.seed, "check").permutation(len(pairs))[:MAX_CHECKED]
        return [pairs[p] for p in sorted(pick.tolist())]

    def _reference(self, rp, i: int, j: int):
        seed = self.seeds(self.base, i)[j]
        sk_hat, vk = ref.keygen(rp, seed)
        return vk, ref.sign(rp, sk_hat, vk, self.msg_sets[i % len(self.msg_sets)][j])

    def check(self) -> dict:
        self.expected = [self._reference(self.rp, i, j) for i, j, _, _ in self._pairs()]
        return judge([(vk, sig) for _, _, vk, sig in self._pairs()], self.expected)

    def control_check(self) -> dict:
        """The checks with the control's keys and signatures in the program's place."""
        cp = ref.control(self.rp)
        return judge([self._reference(cp, i, j) for i, j, _, _ in self._pairs()], self.expected)


def judge(answers, expected) -> dict:
    vk_bad = sum(int(not np.array_equal(a[0], e[0])) for a, e in zip(answers, expected))
    sig_bad = sum(int(not np.array_equal(a[1], e[1])) for a, e in zip(answers, expected))
    return {"vk_mismatches": (vk_bad, 0), "signature_mismatches": (sig_bad, 0)}
