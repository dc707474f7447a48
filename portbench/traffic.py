"""The benchmark's one traffic generator.

A traffic mix is a JSON file of parameters under ``portbench/traffic/``;
this module turns it and ``--seed`` into the inputs of a run, so a new mix
is a new data file.  Every random choice comes from a ``numpy`` generator
seeded by (seed, purpose), so the same seed gives the same inputs, and a
seed changes only the order and the content, never the amount of work:
message lengths are a fixed multiset, permuted by the seed.

Keys of a mix (all optional unless a driver needs them):

* ``message_length``: ``{"fixed": L}`` bytes, or ``{"multiple": m,
  "k_min": a, "k_max": b}``: lengths m·k with every k in [a, b] equally
  often (the counts differ by at most one), in seeded order;
* ``batches``: distinct input batches a run alternates (so no call sees the
  batch of the call before it);
* ``tamper_share``: share of groups made invalid, drawn from the seed; each
  tampered group has one message character or one aggregate coefficient
  changed (``TAMPER_KINDS``);
* ``check_groups``: groups of a batch that the plain reference makes
  (keygen, sign, aggregate) before the window and verifies after it, the
  tampered ones up to half of them;
* ``check_keys_per_call``: keys of each call whose outputs are kept for the
  reference.

Messages are printable ASCII (0x20..0x7e), one UTF-8 byte a character.
Every mix is a closed loop: one caller, calls back to back (``core.py``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

PURPOSES = {"messages": 1, "lengths": 2, "tamper": 3, "keys": 4, "sample": 5, "check": 6,
            "reference_keys": 7}
TAMPER_KINDS = ("message", "aggregate")


def rng(seed: int, purpose: str, *more: int) -> np.random.Generator:
    """The generator of one purpose of a run, from ``--seed`` (any whole
    number, of any size or sign)."""
    s = int(seed)
    return np.random.default_rng(np.random.SeedSequence([abs(s), int(s < 0), PURPOSES[purpose],
                                                         *more]))


def key_seed_base(seed: int, batch: int) -> int:
    """A base for one batch's key seeds, below 2**62, so every key's seeds
    fit the sampler's uint64."""
    return int(rng(seed, "keys", batch).integers(1, 2**62))


def message_lengths(spec: dict, n: int, g: np.random.Generator) -> np.ndarray:
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), dtype=np.int64)
    m, a, b = int(spec["multiple"]), int(spec["k_min"]), int(spec["k_max"])
    ks = np.arange(a, b + 1, dtype=np.int64)
    lengths = m * np.resize(ks, n)  # every k as often as any other, to one
    return lengths[g.permutation(n)]


def messages(traffic: dict, n: int, seed: int, batch: int) -> List[str]:
    """``n`` messages of a batch, made from the seed."""
    lengths = message_lengths(traffic["message_length"], n, rng(seed, "lengths", batch))
    g = rng(seed, "messages", batch)
    text = g.integers(0x20, 0x7F, size=int(lengths.sum()), dtype=np.uint8).tobytes().decode("ascii")
    ends = np.cumsum(lengths)
    starts = ends - lengths
    return [text[s:e] for s, e in zip(starts.tolist(), ends.tolist())]


def tamper_plan(traffic: dict, groups: int, seed: int, batch: int) -> Dict[int, str]:
    """{group: kind} of the groups made invalid in one batch."""
    share = float(traffic.get("tamper_share", 0.0))
    count = int(round(share * groups))
    if share > 0:
        count = max(1, count)
    g = rng(seed, "tamper", batch)
    chosen = np.sort(g.choice(groups, size=count, replace=False))
    which = g.integers(0, len(TAMPER_KINDS), size=count)
    return {int(c): TAMPER_KINDS[int(w)] for c, w in zip(chosen, which)}


def tamper_message(msg: str, g: np.random.Generator) -> str:
    """The message with one character changed to another printable one."""
    i = int(g.integers(0, len(msg)))
    c = chr(0x20 + (ord(msg[i]) - 0x20 + 1 + int(g.integers(0, 94))) % 95)
    return msg[:i] + c + msg[i + 1:]


def tamper(q: int, plan: Dict[int, str], n_signers: int, msgs: List[str], aggs, seed: int,
           batch: int) -> Dict[int, Tuple[int, int, int]]:
    """Make the plan's groups invalid in place: one character of one of the
    group's messages, or one coefficient of its aggregate (int32[G, rank,
    d], centered) moved by a nonzero amount mod ``q`` -> {group: (row,
    column, new value)} of the aggregates changed."""
    g = rng(seed, "tamper", batch, 1)
    agg_groups, changed = [], {}
    for group, kind in sorted(plan.items()):
        if kind == "message":
            k = group * n_signers + int(g.integers(0, n_signers))
            msgs[k] = tamper_message(msgs[k], g)
        else:
            agg_groups.append(group)
    if agg_groups:
        import torch

        n = len(agg_groups)
        gi = torch.tensor(agg_groups, device=aggs.device)
        ri = torch.tensor(g.integers(0, aggs.shape[1], n), device=aggs.device)
        ci = torch.tensor(g.integers(0, aggs.shape[2], n), device=aggs.device)
        old = aggs[gi, ri, ci].cpu().numpy().astype(np.int64)
        new = (old + g.integers(1, q, n)) % q
        new = np.where(new > q // 2, new - q, new)
        aggs[gi, ri, ci] = torch.tensor(new, dtype=torch.int32, device=aggs.device)
        changed = {grp: (int(r), int(c), int(v)) for grp, r, c, v in
                   zip(agg_groups, ri.tolist(), ci.tolist(), new.tolist())}
    return changed


def put_reference_groups(rp, plan: Dict[int, str], seed: int, batch: int, groups: Sequence[int],
                         every: Sequence[str], msgs: List[str], vks, aggs, at: int = 0) -> tuple:
    """Put in place of ``groups`` (global indices; the batch's first group
    is global group ``at``) groups that the plain reference ``rp`` makes
    itself, from key seeds of their own over the traffic's messages
    ``every`` (flat, global), then make the plan's groups (local to the
    batch) invalid -> the reference's copies of ``groups`` with the same
    changes: (vks int64[S, N, 2, d], messages S lists of N, aggs int64[S,
    rank, d])."""
    import torch

    from portbench.reference import fusion_ref as ref

    N = vks.shape[1]
    own_vks, own_msgs, own_aggs = ref.make_groups(
        rp, reference_key_seeds(seed, batch, groups, N),
        [list(every[int(g) * N:(int(g) + 1) * N]) for g in groups])
    local = [int(g) - at for g in groups]
    if local:
        idx = torch.as_tensor(local, device=vks.device)
        vks[idx] = torch.as_tensor(own_vks, dtype=torch.int32).to(vks.device)
        aggs[idx] = torch.as_tensor(own_aggs, dtype=torch.int32).to(aggs.device)
    for g, m in zip(local, own_msgs):
        msgs[g * N:(g + 1) * N] = m
    changed = tamper(rp.modulus, plan, N, msgs, aggs, seed, batch)
    for p, g in enumerate(local):
        if g in changed:
            r, c, v = changed[g]
            own_aggs[p, r, c] = v
    return own_vks, [msgs[g * N:(g + 1) * N] for g in local], own_aggs


def check_sample(plan: Dict[int, str], groups: int, count: int, seed: int,
                 batch: int) -> np.ndarray:
    """Sorted groups the reference verifies, ``count`` of them drawn from the
    seed: the tampered groups, up to half, and valid ones for the rest."""
    pool = np.arange(groups)
    g = rng(seed, "check", batch)
    bad = np.array([p for p in pool if int(p) in plan], dtype=np.int64)
    bad = bad[g.permutation(len(bad))][:count // 2]
    good = np.array([p for p in pool if int(p) not in plan], dtype=np.int64)
    good = good[g.permutation(len(good))][:count - len(bad)]
    return np.sort(np.concatenate([bad, good]))


def reference_key_seeds(seed: int, batch: int, groups: Sequence[int],
                        n_signers: int) -> List[List[int]]:
    """The key seeds of the groups the plain reference makes: group g's key
    n takes base + 2(gN + n) and the next, so no two keys share a seed."""
    base = int(rng(seed, "reference_keys", batch).integers(1, 2**62))
    return [[base + 2 * (int(g) * n_signers + n) for n in range(n_signers)] for g in groups]


def key_samples(calls: int, keys: int, per_call: int, seed: int) -> np.ndarray:
    """int[calls, per_call]: the keys of each call kept for the reference."""
    return rng(seed, "sample").integers(0, keys, size=(calls, per_call))


def plan_verdicts(plan: Dict[int, str], groups: int) -> np.ndarray:
    """bool[groups]: True where the group is left valid."""
    ok = np.ones(groups, dtype=bool)
    ok[list(plan)] = False
    return ok


def split_groups(groups: int, world: int, rank: int) -> Tuple[int, int]:
    if groups % world:
        raise ValueError(f"{groups} groups do not split over {world} ranks")
    per = groups // world
    return rank * per, (rank + 1) * per
