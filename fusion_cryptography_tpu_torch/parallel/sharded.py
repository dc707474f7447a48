"""The sharded lifecycle step and the sharded grouped verify on a (dp, tp)
mesh of ranks.

Port of the JAX package's ``parallel/sharded.py`` (``shard_map`` there):

* batch axis B  -> ``dp`` (keys and signatures data-parallel over ranks);
* rank axis     -> ``tp`` (sk/sig rank rows split over ranks; A·x and the
  verify's observed sum are per-rank partial sums all-reduced over ``tp``);
* the aggregate's signer sum stays local to a dp shard and is all-reduced
  over ``dp``.

The rank (83 or 195) is zero-padded to a multiple of tp: zero rows of A and
sk add nothing to any sum and have norm and weight 0, so the results are
bit-identical to the unsharded computation.

Where JAX's functions take and return global arrays, a rank here takes and
returns its own shards, cut as JAX's ``in_specs`` / ``out_specs`` cut them
(:func:`shard`; ``STEP_IN_SPECS``, ``STEP_OUT_SPECS``).  A modular psum is
an int64 ``all_reduce(SUM)`` of residues in [0, q) followed by ``% q``
(exact below 2**32 ranks); JAX splits residues into 16-bit limbs because
its collectives are int32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.intt_norm_weight import agg_check, agg_table
from ..ops.ntt import ntt_fwd_u
from ..ops.upload import upload
from ..params import Params
from ..scheme import device_pipeline as dpl
from ..scheme import device_setup as ds
from ..scheme import lifecycle as lc
from ..scheme import ring
from ..utils.profiling import count, span
from .distributed import rank_device
from .mesh import mesh_axis, mesh_device

# JAX's PartitionSpecs of the step: (sk [B, 2, rank_p, d], c [B, d], alpha
# [B, d]) -> (vk [B, 2, d], agg [rank_p, d], eq, norm_ok, weight_ok)
STEP_IN_SPECS = (("dp", None, "tp", None), ("dp", None), ("dp", None))
STEP_OUT_SPECS = (("dp", None, None), ("tp", None), (), (), ())
# keys per pass of the step's sk product: the int64 temporaries of one pass
# at secpar=256 are 1.4 GB each
STEP_CHUNK = 4096
# keys per block of device_inputs' generator
INPUT_BLOCK = 1024


def _pad_rank(x: np.ndarray, axis: int, rank_padded: int) -> np.ndarray:
    pad = rank_padded - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def padded_rank(params: Params, mesh: DeviceMesh) -> int:
    """The rank padded to a multiple of the mesh's tp size."""
    tp = mesh_axis(mesh, "tp")[0]
    return -(-params.rank // tp) * tp


def shard(mesh: DeviceMesh, x, spec: Sequence[Optional[str]]):
    """This rank's block of the global array ``x`` (numpy or torch) under
    JAX's PartitionSpec ``spec``: a dimension named by a mesh axis is cut
    into that axis's size of equal blocks and the rank keeps block number
    its index along the axis; unnamed and missing dimensions stay whole."""
    index = []
    for dim, name in enumerate(spec):
        if name is None:
            index.append(slice(None))
            continue
        size, i, _ = mesh_axis(mesh, name)
        n = x.shape[dim]
        if n % size:
            raise ValueError(f"dimension {dim} of size {n} does not split over the "
                             f"{name!r} axis ({size})")
        b = n // size
        index.append(slice(i * b, (i + 1) * b))
    return x[tuple(index)]


def _psum_mod(x: torch.Tensor, q: int, group) -> torch.Tensor:
    """Modular psum over ``group``: residues (or sums of a few residues) in
    int64 summed by one all_reduce, then reduced mod q; ``x`` is consumed."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.remainder_(q)


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or torch) as a contiguous tensor on ``device``; from the
    host through pinned memory, without waiting for the device."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.to(device).contiguous()
    return upload(x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x),
                  device)


def sharded_lifecycle_step(params: Params, mesh: DeviceMesh, device=None):
    """The full lifecycle (keygen, sign, aggregate, verify) of a batch of B
    signers treated as one aggregation group, sharded over ``mesh``.

    Returns ``(step, prepare, rank_p)``.  ``step(sk, c, alpha)`` takes this
    rank's shards (``STEP_IN_SPECS``) of

      sk_coeffs     int32[B, 2, rank_p, d]  (rank-padded short key coefficients)
      c_coeffs      int32[B, d]             (challenge coefficients)
      alpha_coeffs  int32[B, d]             (aggregation coefficients)

    and returns this rank's shards (``STEP_OUT_SPECS``) of (vk int32[B, 2,
    d], agg int32[rank_p, d]) and eq, norm_ok, weight_ok (0-dim bool
    tensors, equal on every rank).  ``prepare(B, seed)`` draws JAX's random
    global inputs (numpy).  Everything runs on the mesh's device (``device``,
    if given, must be it): on the card the NTTs are kernel ``ntt_u`` and the
    verify's aggregate half is kernel ``intt_norm_weight`` on the rank's tp
    shard of the aggregate.
    """
    dev = mesh_device(mesh)
    if device is not None and rank_device(device) != dev:
        raise ValueError(f"device {device} is not the mesh's device {dev}")
    plan = params.plan
    F = plan.field
    q, d = plan.modulus, params.degree
    _, _, dp_group = mesh_axis(mesh, "dp")
    tp, tpi, tp_group = mesh_axis(mesh, "tp")
    rank_p = padded_rank(params, mesh)
    r_loc = rank_p // tp
    a_pad = _pad_rank(np.asarray(params.public_challenge, dtype=np.int32), 0, rank_p)
    a_shard = a_pad[tpi * r_loc:(tpi + 1) * r_loc]
    a_u = upload(np.mod(a_shard.astype(np.int64), q), dev)  # [r_loc, d]
    table = agg_table(F, a_shard, dev)
    norm_bound = min(params.beta_vf, 2**31 - 1)

    def step(sk_coeffs, c_coeffs, alpha_coeffs):
        sk, c, al = (_on(x, dev) for x in (sk_coeffs, c_coeffs, alpha_coeffs))
        b = sk.shape[0]
        if tuple(sk.shape[1:]) != (2, r_loc, d) or tuple(c.shape) != (b, d) \
                or tuple(al.shape) != (b, d):
            raise ValueError(f"step takes shards sk [b, 2, {r_loc}, {d}], c and alpha "
                             f"[b, {d}]; got {tuple(sk.shape)}, {tuple(c.shape)}, "
                             f"{tuple(al.shape)}")
        c_u = ntt_fwd_u(plan, F.to_unsigned(c))  # [b, d]
        al_u = ntt_fwd_u(plan, F.to_unsigned(al))
        vk_u = torch.empty((b, 2, d), dtype=torch.int64, device=dev)
        agg_u = torch.zeros((r_loc, d), dtype=torch.int64, device=dev)
        for lo in range(0, b, STEP_CHUNK):
            hi = min(b, lo + STEP_CHUNK)
            # --- keygen: sk_hat = NTT(sk); this rank's rows of A·sk_hat ---
            sk_u = ntt_fwd_u(plan, F.to_unsigned(sk[lo:hi]))  # [n, 2, r_loc, d]
            vk_u[lo:hi] = ring.mul(sk_u, a_u, q).sum(dim=-2)
            # --- sign, and this dp shard's aggregate Σ α ⊙ sig ---
            sig_u = ring.sign(q, sk_u, c_u[lo:hi])
            del sk_u
            agg_u.add_(ring.aggregate(q, al_u[lo:hi], sig_u)).remainder_(q)
            del sig_u
        vk_u = _psum_mod(vk_u, q, tp_group)  # the A·sk sum spans tp
        agg_u = _psum_mod(agg_u, q, dp_group)  # the signer sum spans dp
        # --- verify: target = Σ α ⊙ (c ⊙ vk_l + vk_r) over all B signers ---
        t = ring.aggregate(q, al_u, ring.sign(q, vk_u.unsqueeze(2), c_u))  # [1, d]
        target = _psum_mod(t[0], q, dp_group)
        agg = F.to_centered(agg_u)
        # this rank's rows: A·agg partial sum, and each row's norm and weight
        observed, nrm, wgt = agg_check(plan, table, agg.unsqueeze(0))
        observed = _psum_mod(observed[0].clone(), q, tp_group)
        ext = torch.stack([nrm.amax(), wgt.amax()])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=tp_group)
        eq = torch.all(target == observed)
        return F.to_centered(vk_u), agg, eq, ext[0] <= norm_bound, ext[1] <= params.omega_vf

    def prepare(B: int, seed: int = 0):
        """The JAX package's random global inputs (sk, c, alpha) as numpy
        arrays: the same generator calls, so the same values."""
        rng = np.random.default_rng(seed)
        sk = rng.integers(-52, 53, size=(B, 2, params.rank, d)).astype(np.int32)
        sk = _pad_rank(sk, 2, rank_p)
        c = rng.integers(-1, 2, size=(B, d)).astype(np.int32)
        al = rng.integers(-1, 2, size=(B, d)).astype(np.int32)
        return sk, c, al

    return step, prepare, rank_p


def device_inputs(params: Params, mesh: DeviceMesh, B: int, seed: int = 0):
    """This rank's shards of random step inputs for B keys, drawn on the
    mesh's device: the values of ``prepare``'s distributions, key block k
    (``INPUT_BLOCK`` keys) from a generator seeded by (seed, k), so the
    global batch is the same at every mesh shape on one device type.  For
    batches whose global host arrays would not fit (65,536 keys at
    secpar=256 are 11 GB of sk)."""
    dev = mesh_device(mesh)
    dp, dpi, _ = mesh_axis(mesh, "dp")
    tp, tpi, _ = mesh_axis(mesh, "tp")
    if B % dp:
        raise ValueError(f"B={B} must be divisible by the dp axis ({dp})")
    d, rank = params.degree, params.rank
    r_loc = padded_rank(params, mesh) // tp
    r0, r1 = tpi * r_loc, min(rank, (tpi + 1) * r_loc)
    b = B // dp
    lo, hi = dpi * b, (dpi + 1) * b
    sk = torch.zeros((b, 2, r_loc, d), dtype=torch.int32, device=dev)
    c = torch.empty((b, d), dtype=torch.int32, device=dev)
    al = torch.empty((b, d), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    for k in range(lo // INPUT_BLOCK, -(-hi // INPUT_BLOCK)):
        blo, bhi = k * INPUT_BLOCK, min(B, (k + 1) * INPUT_BLOCK)
        gen.manual_seed((seed << 32) + k)
        n = bhi - blo
        kw = dict(generator=gen, device=dev, dtype=torch.int32)
        sk_b = torch.randint(-52, 53, (n, 2, rank, d), **kw)
        c_b = torch.randint(-1, 2, (n, d), **kw)
        al_b = torch.randint(-1, 2, (n, d), **kw)
        s, e = max(lo, blo), min(hi, bhi)
        if r1 > r0:
            sk[s - lo:e - lo, :, :r1 - r0] = sk_b[s - blo:e - blo, :, r0:r1]
        c[s - lo:e - lo] = c_b[s - blo:e - blo]
        al[s - lo:e - lo] = al_b[s - blo:e - blo]
    return sk, c, al


def prepare_real(params: Params, rank_p: int, seeds, messages, device=None):
    """Real-data global inputs for ``sharded_lifecycle_step``: secret
    coefficients from the CPython-exact sampler, challenge and aggregation
    coefficients from the hash pipeline (``lifecycle.derive_alphas_grouped``:
    kernels 1, 2 and 4-7 on the card), sorted by str(vk) like the
    reference's aggregation order (fusion.py:661-663).

    Returns (sk int32[B, 2, rank_p, d], c int32[B, d], alpha int32[B, d] as
    numpy arrays in sorted order, the port's KeyBatch on ``device`` (the
    card unless ``"cpu"``; keygen is kernel ``ntt_centered`` there), and the
    order, list[int])."""
    seeds = list(seeds)
    B = len(seeds)
    d, rank = params.degree, params.rank
    keys = lc.keygen(params, seeds, device=device)
    reprs = keys.vk_strs()
    order = sorted(range(B), key=lambda i: reprs[i])
    cc, al = lc.derive_alphas_grouped(params, [reprs[i] for i in order],
                                      [messages[i] for i in order], 1, B, device=device)
    coeffs = ds._sample_sk(params, seeds)[order]  # [B, 2, d]: seeds s and s + 1
    # the reference's per-entry reseed makes all rank entries identical
    sk = np.broadcast_to(coeffs[:, :, None, :], (B, 2, rank, d))
    sk = _pad_rank(np.ascontiguousarray(sk), 2, rank_p)
    return sk, cc[0], al[0], keys, order


def sharded_verify_device(params: Params, mesh: DeviceMesh, vks, messages: Sequence[str], aggs,
                          *, group_chunk: int = dpl.DEFAULT_GROUP_CHUNK,
                          group_hash_chunk: int = dpl.DEFAULT_GROUP_HASH_CHUNK,
                          assembly: str = "fold", axis: str = "dp") -> Tuple[torch.Tensor, ...]:
    """The grouped verify (``verify_batch_device``) data-parallel over the
    ``axis`` of ``mesh`` on the groups dimension.

    vks int32[G, N, 2, d] and aggs int32[G, rank, d] (numpy or torch) and the
    G*N messages are the global inputs; G must be divisible by the axis
    size.  Rank index r uploads and verifies groups [r·G/dp, (r+1)·G/dp)
    only, through every kernel of the verify on the card, and the verdicts
    are all-gathered over the axis, so every rank returns (eq, norm_ok,
    weight_ok) bool[G] on its device, bit-identical to the one-device call.
    Ranks that share an index on the axis (the tp axis of a 2-D mesh)
    verify the same groups.  The rank's share makes no host sync.
    """
    G, N = int(vks.shape[0]), int(vks.shape[1])
    ndp, r, _ = mesh_axis(mesh, axis)
    if G % ndp:
        raise ValueError(f"G={G} must be divisible by the {axis} axis ({ndp})")
    msgs = list(messages)
    if len(msgs) != G * N:
        raise ValueError(f"need {G * N} messages, got {len(msgs)}")
    Gl = G // ndp
    lo, hi = r * Gl, (r + 1) * Gl
    return sharded_verify_local(params, mesh, vks[lo:hi], msgs[lo * N:hi * N], aggs[lo:hi],
                                group_chunk=group_chunk, group_hash_chunk=group_hash_chunk,
                                assembly=assembly, axis=axis)


def sharded_verify_local(params: Params, mesh: DeviceMesh, vks, messages: Sequence[str], aggs,
                         *, group_chunk: int = dpl.DEFAULT_GROUP_CHUNK,
                         group_hash_chunk: int = dpl.DEFAULT_GROUP_HASH_CHUNK,
                         assembly: str = "fold", axis: str = "dp") -> Tuple[torch.Tensor, ...]:
    """:func:`sharded_verify_device` on this rank's own groups: vks
    int32[G/dp, N, 2, d], the G/dp*N messages and aggs int32[G/dp, rank, d]
    are groups [r·G/dp, (r+1)·G/dp) of the global inputs (every rank passes
    the same G/dp), so no rank holds the others' groups.  Returns the
    all-gathered (eq, norm_ok, weight_ok) bool[G] on the rank's device.

    While a profiler records, the rank's share is span ``fct.shard``, and
    the verdicts' exchange in it (the uint8 stack, the all-gather, the
    unpack to bool) span ``fct.shard.gather``; counters ``shard.groups``
    (G/dp) and ``shard.gather_bytes`` (the gathered tensor's 3·G bytes).
    Neither waits for the device."""
    Gl, N = int(vks.shape[0]), int(vks.shape[1])
    ndp, _, group = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)
    with span("fct.shard"):
        count("shard.groups", Gl)
        mine = dpl.verify_batch_device(params, _on(vks, dev), messages, _on(aggs, dev),
                                       group_chunk=group_chunk,
                                       group_hash_chunk=group_hash_chunk, device=dev,
                                       assembly=assembly)
        with span("fct.shard.gather"):
            # NCCL carries bool as bytes: gather the three verdict rows as uint8
            every = torch.empty((ndp * 3, Gl), dtype=torch.uint8, device=dev)
            count("shard.gather_bytes", every.numel())
            dist.all_gather_into_tensor(every, torch.stack(mine).to(torch.uint8), group=group)
            out = every.view(ndp, 3, Gl).transpose(0, 1).reshape(3, Gl * ndp).to(torch.bool)
    return tuple(out.unbind(0))
