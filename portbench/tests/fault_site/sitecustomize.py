"""Loaded at interpreter start by the ranks of the fault tests' worlds (this
directory is put first on their PYTHONPATH): breaks the sharded verify as
``PORTBENCH_FAULT`` names, so the run's check must come out false."""
import os

FAULT = os.environ.get("PORTBENCH_FAULT")

if FAULT:
    import torch
    import torch.distributed as dist

    from fusion_cryptography_tpu_torch.parallel import sharded

    real = sharded.sharded_verify_local
    memo = []

    def broken(params, mesh, vks, messages, aggs, **kw):
        if FAULT == "stale" and memo:
            return memo[0]
        if FAULT == "half":
            h = vks.shape[0] // 2
            out = real(params, mesh, vks[:h], messages[:h * vks.shape[1]], aggs[:h], **kw)
            return tuple(torch.ones(o.shape[0] * 2, dtype=torch.bool) for o in out)
        out = real(params, mesh, vks, messages, aggs, **kw)
        if FAULT == "altered":
            eq = out[0].clone()
            eq[dist.get_rank()] = ~eq[dist.get_rank()]
            out = (eq,) + tuple(out[1:])
        memo.append(out)
        return out

    sharded.sharded_verify_local = broken

    if FAULT == "exchange":
        def no_exchange(out, inp, group=None, async_op=False):
            n = inp.shape[0]
            r = dist.get_rank()
            out.zero_()
            out[r * n:(r + 1) * n] = inp

        dist.all_gather_into_tensor = no_exchange
