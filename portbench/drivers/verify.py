"""Driver of the grouped aggregate-verify on one card:
``scheme/device_pipeline.verify_batch_device``.

Set-up builds ``batches`` fleets of G groups of N signers with the
program's fleet build (``scheme/device_setup.build_fleet``) over the
traffic's messages, puts in place of each batch's sampled groups groups
that the plain reference made itself (its keygen, sign and aggregate, from
key seeds of their own), and makes the plan's groups invalid: one message
character, or one aggregate coefficient, changed.  A call verifies one
batch, the batches in turn, and ends with the verdicts on the host.

Judged after the window: every verdict of every call against the plan
(``plan_mismatches``), and the verdicts of the sampled groups against the
plain reference's verify of the inputs it made (``verdict_mismatches``),
which covers the prehash, the signer and group hashes and the lattice
check.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import roofline
from portbench import traffic as tf
from portbench.driver_base import Driver as Base
from portbench.driver_base import scheme_params
from portbench.reference import fusion_ref as ref

WARM_CALLS = 2


class Batch:
    """One batch's inputs on the device, and the reference's own host copies
    of its sampled groups."""

    def __init__(self, vks, msgs, aggs, plan, sample, own):
        self.vks, self.msgs, self.aggs, self.sample = vks, msgs, aggs, sample
        self.ref_vks, self.ref_msgs, self.ref_aggs = own
        self.ok = tf.plan_verdicts(plan, vks.shape[0])
        self.work = None


class Driver(Base):
    def setup(self) -> None:
        from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
        from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

        c, t = self.config, self.traffic
        self.dp = dp
        self.params, self.rp = scheme_params(c)
        G, N = c["groups"], c["signers"]
        self.batches = []
        for b in range(t["batches"]):
            every = tf.messages(t, G * N, self.seed, b)
            vks, msgs, aggs = build_fleet(self.params, G, N, seed0=tf.key_seed_base(self.seed, b),
                                          messages=every, device=self.device,
                                          assembly=c["assembly"])
            plan = tf.tamper_plan(t, G, self.seed, b)
            sample = tf.check_sample(plan, G, t["check_groups"], self.seed, b)
            own = tf.put_reference_groups(self.rp, plan, self.seed, b, sample, every, msgs, vks,
                                          aggs)
            self.batches.append(Batch(vks, msgs, aggs, plan, sample, own))
        for b in range(len(self.batches)):
            for _ in range(WARM_CALLS):
                self._verify(b)
        self.answers = []

    def _verify(self, b: int) -> np.ndarray:
        x = self.batches[b]
        out = self.dp.verify_batch_device(self.params, x.vks, x.msgs, x.aggs,
                                          assembly=self.config["assembly"])
        with self.span("readback"):
            return torch.stack(out).cpu().numpy()

    def call(self, i: int) -> int:
        b = i % len(self.batches)
        self.answers.append((b, self._verify(b)))
        return self.config["groups"]

    def wraps(self):
        x = self.batches[0]
        P = self.dp.get_pipeline(self.params, self.config["signers"], str(x.vks.device),
                                 self.config["assembly"])
        return ((self.dp, "_message_tensors", "host.pack"), (P, "prehash", "stage.prehash"),
                (P, "signer", "stage.signer"), (P, "group", "stage.group"),
                (P, "lattice", "stage.lattice"))

    def work(self, i: int) -> dict:
        x = self.batches[i % len(self.batches)]
        if x.work is None:
            x.work = roofline.verify_work(self.rp, x.vks.cpu().numpy(), x.msgs)
        return x.work

    def release(self) -> None:
        for x in self.batches:
            x.vks = x.aggs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expect(self, exact: bool = True) -> list:
        """The reference's verdicts bool[S, 3] of each batch's sampled groups
        (with ``exact=False`` the control's)."""
        rp = self.rp if exact else ref.control(self.rp)
        return [ref.verify_groups(rp, x.ref_vks, x.ref_msgs, x.ref_aggs) for x in self.batches]

    def check(self) -> dict:
        self.expected = self.expect()
        return judge(self.answers, self.batches, self.expected)

    def control_check(self) -> dict:
        """The checks with the control's verdicts in the program's place: the
        control's on the sampled groups, the plan's elsewhere."""
        answers = []
        for b, (x, c) in enumerate(zip(self.batches, self.expect(exact=False))):
            v = np.repeat(x.ok[None], 3, axis=0)
            v[:, x.sample] = c.T
            answers.append((b, v))
        return judge(answers, self.batches, self.expected)


def judge(answers, batches, expect) -> dict:
    """{check: (number, limit)} of ``answers`` [(batch, verdicts bool[3,
    G])] against the plan and the reference's ``expect`` [bool[S, 3] a batch]."""
    verdict, plan = 0, 0
    for b, v in answers:
        x = batches[b]
        if v.shape != (3, len(x.ok)):
            verdict += len(x.sample)
            plan += len(x.ok)
            continue
        verdict += int((v[:, x.sample].T != expect[b]).any(axis=1).sum())
        plan += int((v.all(axis=0) != x.ok).sum())
    return {"verdict_mismatches": (verdict, 0), "plan_mismatches": (plan, 0)}
