"""Driver of the data-parallel grouped verify on a world of cards:
``parallel/sharded.sharded_verify_local`` on each rank, mesh (world, 1).

Every rank builds only its own groups [r·G/world, (r+1)·G/world) of each
batch (``build_fleet`` in chunks, the key seeds and messages of the global
batch, as the port's ``pod_scale.local_fleet`` lays them out), puts in
place of the sampled groups it owns groups that the plain reference made
itself, makes the plan's groups of its share invalid, and each call
verifies the rank's groups and all-gathers the verdicts; the call ends
with all G verdicts on the host of every rank.

Judged after the window: each rank's gathered verdicts of every call
against the plan (``plan_mismatches``, summed over the ranks), and each
rank's gathered verdicts of the sampled groups against the plain
reference, which each rank runs on the sampled groups it owns
(``verdict_mismatches``, combined by :func:`merge_checks`).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as tf
from portbench.driver_base import Driver as Base
from portbench.driver_base import scheme_params
from portbench.reference import fusion_ref as ref

WARM_CALLS = 2
FLEET_CHUNK = 8192  # groups of one build_fleet call


class Driver(Base):
    def setup(self) -> None:
        from fusion_cryptography_tpu_torch.parallel.mesh import make_mesh
        from fusion_cryptography_tpu_torch.parallel.sharded import sharded_verify_local
        from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
        from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

        c, t, w = self.config, self.traffic, self.world
        self.dp, self.verify = dp, sharded_verify_local
        self.params, self.rp = scheme_params(c)
        self.mesh = make_mesh((w.size, 1), device=self.device.type)
        G, N = c["groups"], c["signers"]
        lo, hi = tf.split_groups(G, w.size, w.rank)
        d, rank = self.params.degree, self.params.rank
        self.batches = []
        for b in range(t["batches"]):
            every = tf.messages(t, G * N, self.seed, b)
            base = tf.key_seed_base(self.seed, b)
            vks = torch.empty((hi - lo, N, 2, d), dtype=torch.int32, device=self.device)
            aggs = torch.empty((hi - lo, rank, d), dtype=torch.int32, device=self.device)
            msgs = []
            for a in range(lo, hi, FLEET_CHUNK):
                e = min(hi, a + FLEET_CHUNK)
                v, m, g = build_fleet(self.params, e - a, N, seed0=base + a * N,
                                      messages=every[a * N:e * N], device=self.device,
                                      assembly=c["assembly"])
                vks[a - lo:e - lo], aggs[a - lo:e - lo] = v, g
                msgs += m
            plan = tf.tamper_plan(t, G, self.seed, b)
            mine = {g - lo: k for g, k in plan.items() if lo <= g < hi}
            sample = tf.check_sample(plan, G, t["check_groups"], self.seed, b)
            own = sample[(sample >= lo) & (sample < hi)]
            self.batches.append({
                "vks": vks, "msgs": msgs, "aggs": aggs, "sample": sample,
                "own": own.tolist(), "ok": tf.plan_verdicts(plan, G),
                "ref": tf.put_reference_groups(self.rp, mine, self.seed, b, own, every, msgs,
                                               vks, aggs, at=lo),
            })
            del every
        for b in range(len(self.batches)):
            for _ in range(WARM_CALLS):
                self._verify(b)
        self.answers = []

    def _verify(self, b: int) -> np.ndarray:
        x = self.batches[b]
        out = self.verify(self.params, self.mesh, x["vks"], x["msgs"], x["aggs"],
                          assembly=self.config["assembly"])
        with self.span("readback"):
            return torch.stack(out).cpu().numpy()

    def call(self, i: int) -> int:
        b = i % len(self.batches)
        self.answers.append((b, self._verify(b)))
        return self.config["groups"]

    def wraps(self):
        return ((self.dp, "_message_tensors", "host.pack"),)

    def release(self) -> None:
        for x in self.batches:
            x["vks"] = x["aggs"] = None
        torch.cuda.empty_cache()

    def check(self) -> dict:
        """This rank's part: its plan mismatches, the reference's verdicts of
        its own sampled groups, and its gathered verdicts of every sampled
        group in every call."""
        plan, views = 0, []
        for b, v in self.answers:
            x = self.batches[b]
            if v.shape != (3, len(x["ok"])):
                plan += len(x["ok"])
                views.append([b, None])
                continue
            plan += int((v.all(axis=0) != x["ok"]).sum())
            views.append([b, v[:, x["sample"]].T.tolist()])
        self.expected = [self._verdicts(self.rp, x) for x in self.batches]
        expect = [dict(zip(map(str, x["own"]), e.tolist()))
                  for x, e in zip(self.batches, self.expected)]
        return {"plan": plan, "views": views, "expect": expect,
                "samples": [x["sample"].tolist() for x in self.batches]}

    @staticmethod
    def _verdicts(rp, x) -> np.ndarray:
        vks, msgs, aggs = x["ref"]
        return ref.verify_groups(rp, vks, msgs, aggs) if len(msgs) else np.zeros((0, 3), bool)

    def control_check(self) -> dict:
        """This rank's part with the control's verdicts of its own sampled
        groups in the program's place."""
        cp = ref.control(self.rp)
        wrong = sum(int((self._verdicts(cp, x) != e).any(axis=1).sum())
                    for x, e in zip(self.batches, self.expected))
        return {"control_mismatches": wrong}


def merge_checks(parts) -> dict:
    """The run's {check: (number, limit)} from every rank's part."""
    if "control_mismatches" in parts[0]:
        return {"verdict_mismatches": (sum(p["control_mismatches"] for p in parts), 0),
                "plan_mismatches": (0, 0)}
    expect = [{} for _ in parts[0]["expect"]]
    for p in parts:
        for b, e in enumerate(p["expect"]):
            expect[b].update(e)
    verdict = 0
    for p in parts:
        for b, view in p["views"]:
            sample = parts[0]["samples"][b]
            if view is None:
                verdict += len(sample)
                continue
            verdict += sum(1 for g, got in zip(sample, view) if expect[b].get(str(g)) != got)
    return {"verdict_mismatches": (verdict, 0),
            "plan_mismatches": (sum(p["plan"] for p in parts), 0)}
