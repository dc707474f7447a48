"""Pod-scale configurations on a world of ranks (the port of the JAX
package's ``examples/pod_scale.py``, BASELINE.json configs 4 and 5):

* config 4: secpar=256 with 2^16 one-time keys sharded over the cards
  (``--keys 65536``) through ``parallel.sharded_lifecycle_step`` on
  ``make_mesh()``'s default mesh (tp = 2 when the world is even): keys/s;
* config 5: batched aggregation groups of ``SIGNERS`` verified
  data-parallel over every rank (mesh (world, 1)) through
  ``parallel.sharded.sharded_verify_local`` (``--groups 262144`` is 2^20
  signatures): verifies/s.  Each rank builds only its own groups
  (:func:`local_fleet`), so a card holds G/world groups.

    python -m fusion_cryptography_tpu_torch.pod_scale [--keys 65536] [--groups G]
    torchrun --nproc-per-node=K -m fusion_cryptography_tpu_torch.pod_scale --keys 65536

A single process runs as a world of one rank on one card.  Every time is
the best of ``REPS`` calls after a warm one, each at the slowest rank
(:func:`best_seconds`).  ``--efficiency`` adds a
``scaling_efficiency_lifecycle`` line (and ``scaling_efficiency_verify``
with ``--groups``): the K-rank rate above over K times the rate of one
rank (a (1, 1) mesh on rank 0) at the same per-card batch, ``--keys`` / K
keys and ``--groups`` / K groups.  On one card, or on CPU ranks that share
the host's cores, no number printed is a scaling figure, and the line says
so.  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from .params import fusion_setup
from .parallel import distributed
from .parallel.mesh import make_mesh, mesh_axis, mesh_device
from .parallel.sharded import device_inputs, sharded_lifecycle_step, sharded_verify_local

# config 5's signers per aggregation group, the timed calls of a rate, and
# the groups of one build_fleet call in local_fleet
SIGNERS = 4
REPS = 3
FLEET_CHUNK = 8192


def _parse(argv):
    ap = argparse.ArgumentParser(prog="fusion_cryptography_tpu_torch.pod_scale")
    ap.add_argument("--keys", type=int, default=1024, help="total one-time keys (config 4: 65536)")
    ap.add_argument("--groups", type=int, default=0,
                    help=f"aggregation groups of {SIGNERS} to verify (config 5: 262144); 0: skip")
    ap.add_argument("--secpar", type=int, default=256, choices=(128, 256))
    ap.add_argument("--efficiency", action="store_true",
                    help="emit the scaling-efficiency JSON lines "
                         "(throughput_K / (K * throughput_1))")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, the default) or cpu (gloo, the kernels' plain versions)")
    return ap.parse_args(argv)


def best_seconds(fn, mesh) -> float:
    """The best over ``REPS`` of the slowest rank's wall time of ``fn()``
    (after one warm call), each ended by a device sync and, on a mesh of
    the whole world, a barrier.  A mesh is the whole world or one rank."""
    dev = mesh_device(mesh)
    everyone = mesh.mesh.numel() == dist.get_world_size()
    if not everyone and mesh.mesh.numel() != 1:
        raise ValueError("pod_scale times meshes of the whole world or of one rank")

    def timed() -> float:
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if everyone:
            dist.barrier()
        return time.perf_counter() - t0

    timed()
    best = torch.tensor([min(timed() for _ in range(REPS))], dtype=torch.float64, device=dev)
    if everyone:
        dist.all_reduce(best, op=dist.ReduceOp.MAX)
    return float(best.item())


def scaling_efficiency(rate_k: float, rate_1: float, k: int) -> float:
    """throughput_K / (K * throughput_1), both at the same per-card batch."""
    return rate_k / (k * rate_1)


def lifecycle_throughput(params, mesh, inputs) -> tuple:
    """Config 4 on ``mesh``: the step on this rank's shards ``inputs`` (sk,
    c, alpha, as ``device_inputs`` makes them) -> (keys/s and the verdict,
    the last call's outputs (vk, agg, eq, norm_ok, weight_ok))."""
    step, _, rank_p = sharded_lifecycle_step(params, mesh)
    B = inputs[0].shape[0] * mesh_axis(mesh, "dp")[0]
    out = []
    best = best_seconds(lambda: out.append(step(*inputs)), mesh)
    _, _, eq, norm_ok, w_ok = out[-1]
    row = {"keys": B, "rank_p": rank_p, "seconds": best, "keys_per_s": B / best,
           "verified": bool(eq & norm_ok & w_ok)}
    return row, out[-1]


def local_fleet(params, mesh, G: int, axis: str = "dp"):
    """This rank's groups [r·G/dp, (r+1)·G/dp) of ``build_fleet(params, G,
    SIGNERS, seed0=1)``, built on the rank's device over their own seeds and
    messages, ``FLEET_CHUNK`` groups a ``build_fleet`` call (groups are
    independent, so the arrays are that slice of the global fleet, and a
    card's memory grows with G/dp plus one chunk's build)."""
    from .scheme.device_setup import build_fleet

    ndp, r, _ = mesh_axis(mesh, axis)
    if G % ndp:
        raise ValueError(f"G={G} must be divisible by the {axis} axis ({ndp})")
    dev = mesh_device(mesh)
    lo, hi = r * (G // ndp), (r + 1) * (G // ndp)
    d = params.degree
    vks = torch.empty((hi - lo, SIGNERS, 2, d), dtype=torch.int32, device=dev)
    aggs = torch.empty((hi - lo, params.rank, d), dtype=torch.int32, device=dev)
    msgs: list = []
    for a in range(lo, hi, FLEET_CHUNK):
        b = min(hi, a + FLEET_CHUNK)
        names = [f"group{g}:msg{i}" for g in range(a, b) for i in range(SIGNERS)]
        v, m, g = build_fleet(params, b - a, SIGNERS, seed0=1 + a * SIGNERS, messages=names,
                              device=dev)
        vks[a - lo:b - lo], aggs[a - lo:b - lo] = v, g
        msgs += m
    return vks, msgs, aggs


def verify_throughput(params, mesh, fleet) -> tuple:
    """Config 5 on ``mesh``: ``sharded_verify_local`` of this rank's groups
    ``fleet`` (vks, messages, aggs, as :func:`local_fleet` makes them) ->
    (verifies/s and whether every verdict is true, the last call's
    all-gathered verdicts (eq, norm_ok, weight_ok))."""
    vks, msgs, aggs = fleet
    G = int(vks.shape[0]) * mesh_axis(mesh, "dp")[0]
    out = []
    best = best_seconds(lambda: out.append(sharded_verify_local(params, mesh, vks, msgs, aggs)),
                        mesh)
    eq, norm_ok, w_ok = out[-1]
    row = {"groups": G, "signers": int(vks.shape[1]), "seconds": best,
           "verifies_per_s": G / best, "verified": bool((eq & norm_ok & w_ok).all())}
    return row, out[-1]


def _efficiency_line(metric: str, rate: str, many: dict, one, world: int, note) -> dict:
    line = {"metric": metric, "unit": f"throughput_{world}rank / ({world} x throughput_1rank)",
            "ranks": world, f"{rate}_{world}rank": many[rate]}
    if one is not None:
        line["value"] = scaling_efficiency(many[rate], one[rate], world)
        line[f"{rate}_1rank"] = one[rate]
    if note:
        line["note"] = note
    return line


def run(argv=None) -> dict:
    """Run the configurations in the initialized world -> this rank's
    metrics (rank 0 prints them)."""
    args = _parse(argv)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    params = fusion_setup(args.secpar, 42)
    mesh = make_mesh(device=args.device)
    vmesh = make_mesh((world, 1), device=args.device)
    dev = mesh_device(mesh)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    say(f"ranks: {world} ({name}, {cards} cards visible), mesh: {shape}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = {"ranks": world, "mesh": shape, "device": name}
    life, _ = lifecycle_throughput(params, mesh, device_inputs(params, mesh, args.keys))
    metrics["lifecycle"] = life
    say(f"sharded keygen+sign+aggregate+verify for {life['keys']} keys (secpar={args.secpar}, "
        f"rank padded to {life['rank_p']}): {life['seconds'] * 1e3:.1f} ms "
        f"({life['keys_per_s']:,.0f} keys/s across {world} ranks); verified: {life['verified']}")
    if args.groups:
        ver, _ = verify_throughput(params, vmesh, local_fleet(params, vmesh, args.groups))
        metrics["verify"] = ver
        say(f"sharded verify of {ver['groups']} groups x {ver['signers']} "
            f"({ver['groups'] // world} a rank): {ver['seconds'] * 1e3:.1f} ms "
            f"({ver['verifies_per_s']:,.0f} verifies/s across {world} ranks); every verdict "
            f"true: {ver['verified']}")
    if dev.type == "cuda":
        metrics["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        say(f"peak device memory (rank 0): {metrics['peak_mem_gb']:.2f} GB")
    note = None
    if dev.type != "cuda":
        note = ("CPU ranks share the host's cores: these numbers bound the sharding's "
                "overhead, not a card's scaling")
    elif cards < 2 or world < 2:
        note = "one card: none of these numbers is a scaling figure"
    if args.efficiency:
        # one rank at the K-rank run's per-card batch; the others wait on a
        # gloo barrier, on the host, so no NCCL work or stream sync of theirs
        # runs beside it
        mesh1 = make_mesh((1, 1), device=args.device)
        idle = dist.new_group(backend="gloo")
        one_life = one_ver = None
        if rank == 0:
            one_life, _ = lifecycle_throughput(params, mesh1,
                                               device_inputs(params, mesh1, args.keys // world))
            if args.groups:
                one_ver, _ = verify_throughput(params, mesh1,
                                               local_fleet(params, mesh1, args.groups // world))
        dist.barrier(group=idle)
        metrics["efficiency"] = _efficiency_line("scaling_efficiency_lifecycle", "keys_per_s",
                                                 life, one_life, world, note)
        say(json.dumps(metrics["efficiency"]))
        if args.groups:
            metrics["efficiency_verify"] = _efficiency_line(
                "scaling_efficiency_verify", "verifies_per_s", metrics["verify"], one_ver, world,
                note)
            say(json.dumps(metrics["efficiency_verify"]))
    elif note:
        say(note)
    return metrics


def main(argv=None) -> int:
    args = _parse(argv)
    if dist.is_initialized():
        run(argv)
        return 0
    if distributed.initialize(device=args.device) is None:
        with distributed.single_process_world(args.device):
            run(argv)
        return 0
    try:
        run(argv)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
