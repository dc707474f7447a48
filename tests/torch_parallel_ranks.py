"""Rank-side halves of the port's gloo-world tests (test_torch_sharded.py,
test_torch_sharded_verify.py, test_torch_distributed_ntt.py): functions that
``fusion_cryptography_tpu_torch.parallel._launch`` runs on every rank of a
world of CPU processes.  They import the port only, never JAX, and return
numpy arrays: each rank's shards, which the tests reassemble."""
import numpy as np
import torch

from fusion_cryptography_tpu_torch.ops.field import Q
from fusion_cryptography_tpu_torch.ops.ntt import make_plan
from fusion_cryptography_tpu_torch.params import fusion_setup
from fusion_cryptography_tpu_torch.parallel import make_mesh, prepare_real, sharded_lifecycle_step
from fusion_cryptography_tpu_torch.parallel import distributed_ntt as dn
from fusion_cryptography_tpu_torch.parallel.sharded import (
    STEP_IN_SPECS,
    device_inputs,
    shard,
    sharded_verify_device,
    sharded_verify_local,
)
from fusion_cryptography_tpu_torch import pod_scale

_meshes = {}


def _mesh(shape, names=("dp", "tp")):
    key = (tuple(shape), tuple(names))
    if key not in _meshes:
        _meshes[key] = make_mesh(tuple(shape), tuple(names), device="cpu")
    return _meshes[key]


def _numpy(outs):
    return [o.numpy() for o in outs]


def _step(params, shape, inputs=None, seed=None):
    """The step at mesh ``shape`` on the global ``inputs``, or on
    ``prepare(B, seed)``'s when ``inputs`` is an int B -> (this rank's
    outputs, the global inputs)."""
    mesh = _mesh(shape)
    step, prepare, _ = sharded_lifecycle_step(params, mesh)
    if isinstance(inputs, int):
        inputs = prepare(inputs, seed)
    return _numpy(step(*(shard(mesh, x, s) for x, s in zip(inputs, STEP_IN_SPECS)))), inputs


def lifecycle_cases(step_cases, real_case, local_case):
    """step_cases {name: (secpar, setup seed, mesh shape, B, seed)}: the step
    on ``prepare``'s inputs; real_case (secpar, setup seed, mesh shape,
    seeds, messages): the step on ``prepare_real``'s; local_case (secpar,
    setup seed, B, seed, [mesh shapes]): ``device_inputs`` at each shape."""
    out = {}
    for name, (secpar, pseed, shape, B, seed) in step_cases.items():
        out[name], inputs = _step(fusion_setup(secpar, pseed), shape, B, seed)
        out[name + "/prepare"] = list(inputs)
    secpar, pseed, shape, seeds, msgs = real_case
    params = fusion_setup(secpar, pseed)
    _, _, rank_p = sharded_lifecycle_step(params, _mesh(shape))
    sk, cc, al, keys, order = prepare_real(params, rank_p, seeds, msgs, device="cpu")
    out["real"] = _step(params, shape, (sk, cc, al))[0]
    out["real/prepare"] = [sk, cc, al, keys.vk_strs(), order]
    secpar, pseed, B, seed, shapes = local_case
    params = fusion_setup(secpar, pseed)
    for shape in shapes:
        out[f"local/{shape}"] = _numpy(device_inputs(params, _mesh(shape), B, seed))
    return out


def verify_cases(secpar, pseed, vks, msgs, aggs, cases, local_chunks):
    """cases {name: (mesh shape, assembly)}: sharded_verify_device on the
    global fleet (vks, msgs, aggs) -> (eq, norm_ok, weight_ok) per case;
    "local": :func:`local_verify_traced` at ``local_chunks``; "errors": the
    ValueErrors of :func:`mesh_errors`."""
    params = fusion_setup(secpar, pseed)
    out = {name: _numpy(sharded_verify_device(params, _mesh(shape), vks, msgs, aggs,
                                              assembly=assembly))
           for name, (shape, assembly) in cases.items()}
    out["local"] = local_verify_traced(params, vks, msgs, aggs, *local_chunks)
    out["errors"] = mesh_errors()
    return out


SPANS = ("fct.shard", "fct.shard.gather", "fct.verify", "fct.pack")


def local_verify_traced(params, vks, msgs, aggs, group_chunk, group_hash_chunk):
    """sharded_verify_local at mesh (world, 1) on this rank's own groups of
    the global fleet, in signer chunks of ``group_chunk`` groups and windows
    of ``group_hash_chunk``, under a profiler -> {"verdicts": the gathered
    (eq, norm_ok, weight_ok), "spans": {name: [(start, end) us]} of the
    ``SPANS`` it opened, "counters": the program's counters}."""
    from torch.profiler import ProfilerActivity, profile

    from fusion_cryptography_tpu_torch.utils import profiling

    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    G, N = vks.shape[0], vks.shape[1]
    lo, hi = rank * G // world, (rank + 1) * G // world
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sharded_verify_local(params, _mesh((world, 1)), vks[lo:hi], msgs[lo * N:hi * N],
                                   aggs[lo:hi], group_chunk=group_chunk,
                                   group_hash_chunk=group_hash_chunk)
    spans = {name: sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                          if e.name == name) for name in SPANS}
    return {"verdicts": _numpy(out), "spans": spans, "counters": profiling.counters()}


def world_of_one(secpar, pseed, seeds, msgs, fleet):
    """A world of one rank: the step on prepare_real's inputs and the
    sharded verify at mesh (1, 1)."""
    params = fusion_setup(secpar, pseed)
    _, _, rank_p = sharded_lifecycle_step(params, _mesh((1, 1)))
    sk, cc, al, keys, order = prepare_real(params, rank_p, seeds, msgs, device="cpu")
    vks, fmsgs, aggs = fleet
    return {"step": _step(params, (1, 1), (sk, cc, al))[0], "order": order,
            "verify": _numpy(sharded_verify_device(params, _mesh((1, 1)), vks, fmsgs, aggs))}


def local_fleet_case(secpar, pseed, G, bad, chunk):
    """pod_scale.local_fleet of G groups on mesh (world, 1), built ``chunk``
    groups a build_fleet call, and sharded_verify_local on it with global
    group ``bad``'s aggregate tampered -> (this rank's vks, messages, aggs,
    the verdicts)."""
    pod_scale.FLEET_CHUNK = chunk
    params = fusion_setup(secpar, pseed)
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    mesh = _mesh((world, 1))
    vks, msgs, aggs = pod_scale.local_fleet(params, mesh, G)
    fleet = [vks.numpy(), msgs, aggs.numpy().copy()]
    lo = rank * (G // world)
    if lo <= bad < lo + G // world:
        aggs[bad - lo, 0, 0] = (aggs[bad - lo, 0, 0] + 1) % Q
    return fleet + [_numpy(sharded_verify_local(params, mesh, vks, msgs, aggs))]


def ntt_cases(matrix_cases, fourstep_cases, x_by_d, g_by_d):
    """matrix_cases {name: (d, root, S)}; fourstep_cases {name: (d, root, S,
    order)}.  Each transform runs on this rank's block of the global inputs
    x_by_d[d] (and g_by_d[d] for the four-step pointwise product) on a mesh
    (S, world // S) named ("sp", "rep"); returns this rank's blocks and,
    for the four-step cases with S^2 | d, fourstep_order's probe."""
    world = torch.distributed.get_world_size()
    out = {}
    for name, (d, root, S) in matrix_cases.items():
        plan = make_plan(Q, d, root)
        mesh = _mesh((S, world // S), ("sp", "rep"))
        fwd, inv = dn.make_distributed_ntt(plan, mesh)
        x = shard(mesh, torch.from_numpy(x_by_d[d]), (None, "sp"))
        y = fwd(x)
        out[name] = [y.numpy(), inv(y).numpy(), inv(x).numpy()]
    for name, (d, root, S, order) in fourstep_cases.items():
        plan = make_plan(Q, d, root)
        mesh = _mesh((S, world // S), ("sp", "rep"))
        fwd, inv, layout, unlayout = dn.make_fourstep_ntt(plan, mesh, order=order)
        F = plan.field
        xs = shard(mesh, layout(x_by_d[d]), (None, "sp"))
        gs = shard(mesh, layout(g_by_d[d]), (None, "sp"))
        y, gh = fwd(xs), fwd(gs)
        prod = F.to_centered(F.mont_mul(F.to_mont(F.to_unsigned(y)), F.to_unsigned(gh)))
        res = {"order": fwd.order, "out_width": fwd.out_width, "y": y.numpy(),
               "back": inv(y).numpy(), "prod": inv(prod).numpy()}
        if (d // S) % S == 0:
            res["probe"] = dn.fourstep_order(plan, fwd, layout)
        try:
            dn.make_fourstep_ntt(plan, mesh, order="reference")
            res["reference_ok"] = True
        except ValueError as e:
            res["reference_ok"] = str(e)
        out[name] = res
    return out


def mesh_errors():
    """The ValueErrors of the mesh and the sharded functions in a world of
    4, by case (None where nothing was raised)."""
    msgs = {}
    for key, fn in {
        "too_many_ranks": lambda: make_mesh((8, 8), device="cpu"),
        "verify_not_divisible": lambda: sharded_verify_device(
            fusion_setup(128, 7), _mesh((4, 1)), np.zeros((6, 2, 2, 64), np.int32),
            ["m"] * 12, np.zeros((6, 195, 64), np.int32)),
        "verify_messages": lambda: sharded_verify_device(
            fusion_setup(128, 7), _mesh((4, 1)), np.zeros((8, 2, 2, 64), np.int32),
            ["m"] * 15, np.zeros((8, 195, 64), np.int32)),
        "inputs_not_divisible": lambda: device_inputs(fusion_setup(128, 7), _mesh((4, 1)), 6),
    }.items():
        try:
            fn()
            msgs[key] = None
        except ValueError as e:
            msgs[key] = str(e)
    return msgs


def fail_on(bad_rank):
    """Raise on ``bad_rank``; the other ranks wait in a barrier it never
    reaches."""
    if torch.distributed.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    torch.distributed.barrier()


def hang_on(bad_rank):
    """``bad_rank`` sleeps past any test's time; the others wait for it in a
    barrier."""
    import time

    if torch.distributed.get_rank() == bad_rank:
        time.sleep(3600)
    torch.distributed.barrier()
