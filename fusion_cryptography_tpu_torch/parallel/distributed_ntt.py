"""Coefficient-sharded (sequence-parallel) negacyclic NTT over a mesh axis.

Port of the JAX package's ``parallel/distributed_ntt.py``: the polynomial
coefficient axis itself split over the ranks of one mesh axis (``sp``), in
two forms.

* Matrix form (:func:`make_distributed_ntt`): out[i] = f(psi^(2·bitrev(i)+1))
  is a d×d matrix-vector product over Z_q; a rank multiplies its column
  block of the transform matrix by its coefficients, and one
  ``reduce_scatter_tensor`` sums the partials and leaves each rank its block
  of outputs.  Bit-identical to ``ops/ntt.py`` (the reference's bit-reversed
  NTT-domain order).  O(d²/S) work a rank: the correctness oracle.
* Four-step form (:func:`make_fourstep_ntt`): local cyclic DFTs of the
  rank's residue class, one ``all_to_all_single`` a transform, and a local
  S-point DFT: O(d/S · log d) work a rank.

A rank takes and returns its own column block, int32[B, d/S] (JAX's
``P(None, "sp")``).  The collectives cut dimension 0, so the exchanged axis
is moved to the front and made contiguous before each one.  Residues are
int64 and every product is reduced mod q before a sum.  No kernel stands
behind these transforms in the JAX package either (``shard_map`` of jnp
ops there); here they are torch ops and collectives on the mesh's device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.field import Field
from ..ops.ntt import NTTPlan
from ..ops.numtheory import bit_reverse_indices
from ..ops.upload import upload
from .mesh import mesh_axis, mesh_device

# int64 elements of the matrix form's product temporary [rows, d, d/S]:
# 256 MB, so B = 8,192 rows at d = 256, S = 1 (4.3 GB at once) go in chunks
_MATRIX_TEMP_ELEMS = 1 << 25


@lru_cache(maxsize=None)
def _transform_matrices(plan: NTTPlan) -> Tuple[np.ndarray, np.ndarray]:
    """(V, W): forward/inverse transform matrices as uint32 residues.

    V[i, j] = psi^((2·bitrev(i)+1)·j);  W[j, i] = d^{-1}·psi^(-(2·bitrev(i)+1)·j).
    """
    q, d, psi = plan.modulus, plan.degree, plan.root
    idx = bit_reverse_indices(d)
    inv_psi = plan.inv_root
    d_inv = pow(d, q - 2, q)
    V = np.empty((d, d), dtype=np.uint32)
    W = np.empty((d, d), dtype=np.uint32)
    for i in range(d):
        e = 2 * idx[i] + 1
        base = pow(psi, e, q)
        inv_base = pow(inv_psi, e, q)
        row = 1
        for j in range(d):
            V[i, j] = row
            row = row * base % q
        col = d_inv
        for j in range(d):
            W[j, i] = col
            col = col * inv_base % q
    return V, W


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` moved to the front, contiguous: the layout the
    dimension-0 collectives cut."""
    return x.movedim(dim, 0).contiguous()


def make_distributed_ntt(plan: NTTPlan, mesh: DeviceMesh, axis_name: str = "sp"):
    """Sharded transforms over ``mesh[axis_name]`` (S ranks).

    Returns ``(fwd, inv)``, each mapping this rank's block int32[B, d/S] of
    the coefficient axis (rank s holds columns [s·d/S, (s+1)·d/S)) to its
    block of the result; every rank of the axis takes the same B rows.
    Outputs are bit-identical to ops/ntt.py's ``ntt_fwd`` / ``ntt_inv``.
    """
    F = plan.field
    q, d = plan.modulus, plan.degree
    S, s, group = mesh_axis(mesh, axis_name)
    if d % S != 0:
        raise ValueError(f"degree {d} not divisible by {S} shards")
    dev = mesh_device(mesh)
    w = d // S
    V, W = _transform_matrices(plan)
    # this rank's column block of each matrix [d, d/S]
    v_cols = upload(V[:, s * w:(s + 1) * w].astype(np.int64), dev)
    w_cols = upload(W[:, s * w:(s + 1) * w].astype(np.int64), dev)
    rows = max(1, _MATRIX_TEMP_ELEMS // (d * w))

    def apply(m_cols: torch.Tensor, x) -> torch.Tensor:
        u = F.to_unsigned(torch.as_tensor(x, device=dev))  # [B, d/S]
        B = u.shape[0]
        partial = torch.empty((d, B), dtype=torch.int64, device=dev)  # output index first
        for lo in range(0, B, rows):
            hi = min(B, lo + rows)
            prods = (m_cols * u[lo:hi, None, :]).remainder_(q)  # [n, d, d/S]
            partial[:, lo:hi] = prods.sum(dim=-1).remainder_(q).t()
        out = torch.empty((w, B), dtype=torch.int64, device=dev)
        dist.reduce_scatter_tensor(out, partial, group=group)
        return F.to_centered(out.remainder_(q).t()).contiguous()

    def fwd(x):
        """int32[B, d/S] (coefficient domain) -> int32[B, d/S] NTT domain."""
        return apply(v_cols, x)

    def inv(x):
        """int32[B, d/S] NTT domain -> int32[B, d/S] coefficient domain."""
        return apply(w_cols, x)

    return fwd, inv


# ---------------------------------------------------------------------------
# Butterfly-exchange (four-step) distributed NTT: O(d/S · log d) local work +
# ONE all_to_all per transform.
# ---------------------------------------------------------------------------


def _cyclic_stage_tables(F: Field, n: int, root: int, inverse: bool) -> List[Tuple[int, np.ndarray]]:
    """Twiddle tables for a radix-2 cyclic DFT of size n with the given
    primitive n-th root: DIF (natural in -> bitrev out) for the forward,
    DIT mirror for the inverse.  Returns a list of (span, w)."""
    q = F.q
    w = pow(root, q - 2, q) if inverse else root
    spans = []
    s = n // 2
    while s >= 1:
        step = n // (2 * s)
        spans.append((s, np.array([pow(w, j * step, q) for j in range(s)], dtype=np.int64)))
        s //= 2
    if inverse:
        spans.reverse()  # DIT: spans 1, 2, ..., n/2
    return spans


def _cyclic_dft(F: Field, n: int, x: torch.Tensor, stages, inverse: bool) -> torch.Tensor:
    """Radix-2 cyclic DFT on the trailing axis of int64 residues; ``stages``
    holds (span, twiddles int64[span] on x's device)."""
    q = F.q
    lead = x.shape[:-1]
    for s, w in stages:
        m = n // (2 * s)
        x = x.reshape(lead + (m, 2, s))
        u = x[..., 0, :]
        v = x[..., 1, :]
        if inverse:
            v = (v * w).remainder_(q)
            x = torch.stack([F.add_mod(u, v), F.sub_mod(u, v)], dim=-2)
        else:
            x = torch.stack([F.add_mod(u, v), (F.sub_mod(u, v) * w).remainder_(q)], dim=-2)
    return x.reshape(lead + (n,))


def fourstep_perm(plan: NTTPlan, S: int) -> np.ndarray:
    """CLOSED-FORM four-step output permutation (int64[S*S*c], c = ceil(d2/S)).

    ``perm[g]`` is the reference (butterfly, ops/ntt.py) NTT-domain slot whose
    value the four-step pipeline emits at global output slot ``g``, or -1 for
    a padding slot (present only when S^2 does not divide d).

    Derivation: with j = j1 + S*j2 and k = k2 + d2*k1, omega^(S*j2*d2*k1) = 1,
    so the pipeline's local-DFT (frequency k2, emitted in d2-bit-reversed slot
    order), step-3 twiddle omega^(j1*k2), and step-5 S-point DFT (frequency
    k1) compose to the size-d cyclic DFT at frequency k = k2 + d2*k1.  Global
    slot g = b*(S*c) + k1*c + p_off on shard b carries local-DFT slot
    p = b*c + p_off, i.e. k2 = bitrev_d2(p); the reference transform emits
    frequency k at slot bitrev_d(k) (its bit-reversed output).
    """
    d = plan.degree
    if d % S:
        raise ValueError(f"degree {d} not divisible by {S} shards")
    d2 = d // S
    c = -(-d2 // S)
    brv2 = bit_reverse_indices(d2)
    brvd = bit_reverse_indices(d)
    perm = np.full(S * S * c, -1, dtype=np.int64)
    for b in range(S):
        for k1 in range(S):
            for p_off in range(c):
                p = b * c + p_off
                if p >= d2:
                    continue  # padding slot
                k = int(brv2[p]) + d2 * k1
                perm[b * (S * c) + k1 * c + p_off] = brvd[k]
    return perm


def _reference_gather_tables(plan: NTTPlan, S: int) -> np.ndarray:
    """Per-shard local gather emitting REFERENCE NTT-domain order from the
    four-step output, int32[S, 2, d2]: when S^2 | d the shard that four-step
    assigns to a k2-class is exactly the shard the reference-sharded layout
    needs (ref slot i lives on shard i >> log2(d2) = rev_S(k mod S) =
    rev_S(k2 mod S), since d2*k1 vanishes mod S), so the reorder is local
    and needs no collective."""
    d = plan.degree
    d2 = d // S
    if d2 % S:
        raise ValueError("reference-order fusion needs S^2 | d")
    perm = fourstep_perm(plan, S)  # [d], no -1 here
    tables = np.empty((S, 2, d2), dtype=np.int32)  # [:, 0] emit, [:, 1] undo
    for b in range(S):
        local = perm[b * d2:(b + 1) * d2]  # ref slots of this shard's outputs
        if not np.all(local // d2 == b):
            raise AssertionError("four-step shard is not ref-pure")
        fs2ref = (local % d2).astype(np.int32)  # four-step slot r -> ref local
        ref2fs = np.empty(d2, dtype=np.int32)
        ref2fs[fs2ref] = np.arange(d2, dtype=np.int32)
        tables[b, 0] = ref2fs  # out_ref[i] = out_4s[ref2fs[i]]
        tables[b, 1] = fs2ref  # u_4s[r] = u_ref[fs2ref[r]]
    return tables


def _all_to_all(u: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``all_to_all(u, axis, 1, 1)`` on u [B, S, c]: block j of axis 1
    goes to rank j, and axis 1 of the result holds the blocks received, in
    rank order."""
    t = _front(u, 1)  # [S, B, c]
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out.movedim(0, 1)


def make_fourstep_ntt(plan: NTTPlan, mesh: DeviceMesh, axis_name: str = "sp",
                      order: str = None):
    """Coefficient-sharded negacyclic NTT via the four-step factorization:

      1. scale by psi^j (local; negacyclic -> cyclic reduction),
      2. local cyclic DFT of size d/S over each rank's residue class
         (coefficients are cyclically sharded: rank j1 holds {j ≡ j1 mod S}),
      3. local twiddle by omega^(j1·k2),
      4. ONE ``all_to_all_single`` exchanging k2-chunks for j1-rows,
      5. local S-point DFT across the gathered j1 axis.

    Works for any power-of-two S dividing d.  When S^2 does not divide d the
    k2 axis is zero-padded to S*ceil(d2/S) columns before the exchange, so
    outputs carry padding slots (see :func:`fourstep_perm`).

    ``order``: ``"reference"`` (the default when S^2 | d) emits the
    reference NTT-domain slot order, shard-aligned, through a local reorder
    (:func:`_reference_gather_tables`); ``"fourstep"`` (the only choice when
    S^2 does not divide d) the raw four-step order, mapped by
    :func:`fourstep_perm`.  Pointwise products need both operands in one
    order; ``inv`` undoes ``fwd`` exactly.

    Returns ``(fwd, inv, layout, unlayout)``: fwd/inv map this rank's block
    of width d'/S (d' = S*S*c >= d; d without padding) of the cyclic layout
    ``x_cyclic[:, j1*d2 + j2] = x[:, j1 + S*j2]``, which ``layout`` /
    ``unlayout`` make from and return to natural order on global arrays.
    ``fwd.order``, ``fwd.out_width`` (d'), ``fwd.mesh`` and
    ``fwd.axis_name`` describe it (the same on ``inv``).
    """
    F = plan.field
    q = plan.modulus
    d = plan.degree
    psi = plan.root
    S, b, group = mesh_axis(mesh, axis_name)
    if d % S != 0:
        raise ValueError(f"degree {d} must be divisible by S={S} shards")
    d2 = d // S
    if order is None:
        order = "reference" if d2 % S == 0 else "fourstep"
    if order == "reference" and d2 % S:
        raise ValueError("order='reference' needs S^2 | d (use 'fourstep')")
    if order not in ("reference", "fourstep"):
        raise ValueError(f"unknown order {order!r}")
    dev = mesh_device(mesh)
    c = -(-d2 // S)  # k2-chunk width per shard (padded when S^2 does not divide d)
    omega = pow(psi, 2, q)          # order d
    omega_d1 = pow(omega, S, q)     # order d2: local DFT root
    omega_d2 = pow(omega, d2, q)    # order S: cross-shard DFT root
    brv2 = bit_reverse_indices(d2)
    inv_psi, inv_om = plan.inv_root, pow(omega, q - 2, q)

    def on_dev(a) -> torch.Tensor:
        return upload(np.asarray(a, dtype=np.int64), dev)

    # this rank's rows (j1 = b) of the step-1 and step-3 tables, both ways
    psi_row = on_dev([pow(psi, b + S * j2, q) for j2 in range(d2)])
    tw_row = on_dev([pow(omega, b * int(brv2[p]), q) for p in range(d2)])
    ipsi_row = on_dev([pow(inv_psi, b + S * j2, q) for j2 in range(d2)])
    itw_row = on_dev([pow(inv_om, b * int(brv2[p]), q) for p in range(d2)])
    fwd_stages = [(s, on_dev(t)) for s, t in _cyclic_stage_tables(F, d2, omega_d1, False)]
    inv_stages = [(s, on_dev(t)) for s, t in _cyclic_stage_tables(F, d2, omega_d1, True)]
    # cross-shard S-point DFT matrices [S_out, S_in], natural order
    inv_od2, s_inv = pow(omega_d2, q - 2, q), pow(S, q - 2, q)
    m_f = on_dev([[pow(omega_d2, j * k, q) for j in range(S)] for k in range(S)])
    m_i = on_dev([[pow(inv_od2, j * k, q) * s_inv % q for j in range(S)] for k in range(S)])
    d2_inv = pow(d2, q - 2, q)
    gather = None
    if order == "reference":
        gather = upload(_reference_gather_tables(plan, S)[b].astype(np.int64), dev)  # [2, d2]

    def cross(m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """out[:, k] = Σ_j m[k, j] · u[:, j] mod q on u [B, S, c]."""
        return (m[None, :, :, None] * u[:, None, :, :]).remainder_(q).sum(dim=2).remainder_(q)

    def fwd(x):
        """This rank's residue class int32[B, d2] -> its output slots
        int32[B, S*c]."""
        u = F.to_unsigned(torch.as_tensor(x, device=dev))
        B = u.shape[0]
        u = (u * psi_row).remainder_(q)                             # step 1
        u = _cyclic_dft(F, d2, u, fwd_stages, inverse=False)        # step 2
        u = (u * tw_row).remainder_(q)                              # step 3
        if S * c > d2:  # S^2 does not divide d: zero-pad the k2 axis
            u = torch.nn.functional.pad(u, (0, S * c - d2))
        u = _all_to_all(u.reshape(B, S, c), group)                  # step 4
        out = cross(m_f, u).reshape(B, S * c)                       # step 5
        if gather is not None:
            out = out[:, gather[0]]  # reference-order emit: a local reorder
        return F.to_centered(out)

    def inv(y):
        """This rank's output slots int32[B, S*c] -> its residue class
        int32[B, d2]."""
        u = F.to_unsigned(torch.as_tensor(y, device=dev))
        B = u.shape[0]
        if gather is not None:
            u = u[:, gather[1]]  # back to four-step slot order
        u = cross(m_i, u.reshape(B, S, c))                          # undo step 5 (+1/S)
        u = _all_to_all(u, group).reshape(B, S * c)[:, :d2]         # undo step 4
        u = (u * itw_row).remainder_(q)                             # undo step 3
        u = _cyclic_dft(F, d2, u, inv_stages, inverse=True)         # undo step 2
        u = (u * d2_inv).remainder_(q)
        u = (u * ipsi_row).remainder_(q)                            # undo step 1
        return F.to_centered(u)

    for fn in (fwd, inv):
        fn.order, fn.out_width = order, S * S * c
        fn.mesh, fn.axis_name = mesh, axis_name

    def layout(x):
        """Natural coefficient order int[B, d] -> the cyclic shard layout."""
        x = torch.as_tensor(x)
        return x.reshape(-1, d2, S).transpose(1, 2).reshape(-1, d)

    def unlayout(xc):
        xc = torch.as_tensor(xc)
        return xc.reshape(-1, S, d2).transpose(1, 2).reshape(-1, d)

    return fwd, inv, layout, unlayout


def gather_columns(y: torch.Tensor, mesh: DeviceMesh, axis_name: str = "sp") -> torch.Tensor:
    """The global [B, S·w] array from each rank's column block [B, w] along
    ``axis_name`` (an all_gather; every rank gets it)."""
    S, _, group = mesh_axis(mesh, axis_name)
    t = _front(y, 1)  # [w, B]
    out = torch.empty((S * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, 1)


def fourstep_order(plan: NTTPlan, fwd, layout) -> np.ndarray:
    """Recover the permutation mapping four-step output slots to the
    reference (butterfly) NTT-domain ordering:

        fourstep_fwd(layout(x))[:, p] == ntt_fwd(x)[:, perm[p]]

    on the global arrays, by probing ``fwd`` (every rank of its axis calls
    this) with a random input, whose slot values are distinct with
    overwhelming probability (retried otherwise), and checking a second
    probe.  The reference is ``ops/ntt.ntt_fwd`` on the mesh's device."""
    from ..ops.ntt import ntt_fwd
    from .sharded import shard

    mesh, name = fwd.mesh, fwd.axis_name
    dev = mesh_device(mesh)
    d = plan.degree

    def probe(x: np.ndarray):
        ref = ntt_fwd(plan, torch.from_numpy(x).to(dev)).cpu().numpy()[0]
        mine = shard(mesh, layout(torch.from_numpy(x)), (None, name))
        got = gather_columns(fwd(mine.to(dev)), mesh, name).cpu().numpy()[0]
        return ref, got

    rng = np.random.default_rng(0)
    for _ in range(8):
        x = rng.integers(-(plan.modulus // 2), plan.modulus // 2, size=(1, d)).astype(np.int32)
        ref, got = probe(x)
        if len(set(ref.tolist())) != d:
            continue
        pos = {int(v): i for i, v in enumerate(ref)}
        perm = np.array([pos[int(v)] for v in got], dtype=np.int64)
        # verify on an independent probe
        ref2, got2 = probe(rng.integers(-1000, 1000, size=(1, d)).astype(np.int32))
        if np.array_equal(got2, ref2[perm]):
            return perm
    raise RuntimeError("failed to recover a consistent four-step permutation")
