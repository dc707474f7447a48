"""Batched negacyclic NTT / inverse NTT over Z_q: CUDA kernels and their
plain versions.

Port of the JAX package's ``ops/ntt.py`` (the reference's algebra/ntt.py:216-291
Cooley–Tukey forward and :294-377 Gentleman–Sande inverse).  Twiddles are the
powers of the order-2d root in bit-reversed order, the reference's table
layout, so the forward output is in the same bit-reversed order and the
inverse takes it.

Two forms, as in the JAX package: ``ntt_fwd_u`` / ``ntt_inv_u`` on int64
residues in ``[0, q)``, and ``ntt_fwd`` / ``ntt_inv`` on centered int32.  On
a CUDA tensor each launches one kernel of ``csrc/ntt.cu`` (or raises): the
residue form is the counterpart of the JAX package's dense MXU kernel
(``ops/ntt_mxu_pallas.py``), the centered form that of its fused stage kernel
(``ops/ntt_pallas.py``).  On a CPU tensor they run the plain versions
(``*_plain``), radix-2 stage sweeps over the trailing axis: a stage with
``m`` blocks of span ``2t`` is a view ``(..., m, 2, t)`` and lane-wise
butterflies.  The inverse transform fused with the verify's norm/weight
reduction is the kernel of ``ops/intt_norm_weight.py``, which reads this
plan's flat tables too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .field import Field, Q, get_field
from .numtheory import bit_reverse_indices, is_odd_prime, is_primitive_root
from .upload import upload


@dataclass(frozen=True, eq=False)  # identity hash: plans are interned by make_plan
class NTTPlan:
    """Precomputed twiddle schedule for one (modulus, degree, root) transform."""

    field: Field
    degree: int
    root: int
    inv_root: int
    root_order: int
    # stages: (blocks, span, twiddles int64[blocks]) in application order
    fwd_stages: Tuple[Tuple[int, int, np.ndarray], ...]
    inv_stages: Tuple[Tuple[int, int, np.ndarray], ...]
    n_inv: int
    n_inv_shoup: int
    # flat bit-reversed twiddles (the stage with m blocks reads [m:2m]) and
    # their Shoup words, uint32: the layout the CUDA kernels read
    brp: np.ndarray
    brp_shoup: np.ndarray
    brp_inv: np.ndarray
    brp_inv_shoup: np.ndarray
    _device_tables: Dict[tuple, object] = field(default_factory=dict, repr=False)

    @property
    def modulus(self) -> int:
        return self.field.q

    def on_device(self, name: str, device: torch.device, build: Callable[[], object]):
        """``build()``'s tensors for ``device``, made once per plan."""
        key = (name, str(device))
        if key not in self._device_tables:
            self._device_tables[key] = build()
        return self._device_tables[key]

    def tables(self, device: torch.device) -> tuple:
        """Per-device stage twiddles: (fwd [int64[m, 1]...], inv [...])."""
        return self.on_device("stages", device, lambda: tuple(
            [upload(s, device).view(-1, 1) for _, _, s in stages]
            for stages in (self.fwd_stages, self.inv_stages)
        ))

    def twiddles(self, inverse: bool, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The CUDA kernels' flat twiddles and their Shoup words (``brp`` or
        ``brp_inv``) on ``device``, as int32 bit patterns."""
        tables = (self.brp_inv, self.brp_inv_shoup) if inverse else (self.brp, self.brp_shoup)
        return self.on_device(f"twiddles_{int(inverse)}", device, lambda: tuple(
            upload(t.view(np.int32), device) for t in tables
        ))


@lru_cache(maxsize=None)
def make_plan(modulus: int = Q, degree: int = 256, root: Optional[int] = None) -> NTTPlan:
    """Build (and intern) the twiddle tables for one transform size; same
    layout as the JAX package's ``make_plan``."""
    if root is None:
        from .numtheory import find_primitive_root

        root = find_primitive_root(modulus, 2 * degree)
    if not is_odd_prime(modulus):
        raise ValueError(f"modulus={modulus} must be an odd prime")
    root_order = 2 * degree
    if not is_primitive_root(root, modulus, root_order):
        raise ValueError(f"root={root} is not a primitive root of order {root_order}")
    fld = get_field(modulus)
    inv_root = pow(root, modulus - 2, modulus)

    idx = bit_reverse_indices(degree)
    brp = [pow(root, i, modulus) for i in idx]
    brp_inv = [pow(inv_root, i, modulus) for i in idx]

    def stage(tbl: List[int], lo: int, hi: int) -> np.ndarray:
        return np.array(tbl[lo:hi], dtype=np.int64)

    fwd = []
    m = 1
    while m < degree:
        fwd.append((m, degree // (2 * m), stage(brp, m, 2 * m)))
        m *= 2
    inv = []
    h = degree // 2
    while h >= 1:
        inv.append((h, degree // (2 * h), stage(brp_inv, h, 2 * h)))
        h //= 2

    n_inv = pow(degree, modulus - 2, modulus)
    return NTTPlan(
        field=fld,
        degree=degree,
        root=root,
        inv_root=inv_root,
        root_order=root_order,
        fwd_stages=tuple(fwd),
        inv_stages=tuple(inv),
        n_inv=n_inv,
        n_inv_shoup=fld.shoup(n_inv),
        brp=np.array(brp, dtype=np.uint32),
        brp_shoup=np.array([fld.shoup(x) for x in brp], dtype=np.uint32),
        brp_inv=np.array(brp_inv, dtype=np.uint32),
        brp_inv_shoup=np.array([fld.shoup(x) for x in brp_inv], dtype=np.uint32),
    )


def ntt_fwd_u_plain(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of int64 residues along the trailing axis
    (standard order in, bit-reversed order out): the stage sweep."""
    q = plan.modulus
    shape = x.shape
    lead = shape[:-1]
    fwd, _ = plan.tables(x.device)
    for (m, t, _), s in zip(plan.fwd_stages, fwd):
        x = x.reshape(lead + (m, 2, t))
        u = x[..., 0, :]
        v = (x[..., 1, :] * s) % q
        a = u + v
        b = u - v
        x = torch.stack(
            [torch.where(a >= q, a - q, a), torch.where(b < 0, b + q, b)], dim=-2
        )
    return x.reshape(shape)


def ntt_inv_u_plain(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT of int64 residues (bit-reversed order in,
    standard order out, with the final n^-1 scale): the stage sweep."""
    q = plan.modulus
    shape = x.shape
    lead = shape[:-1]
    _, inv = plan.tables(x.device)
    for (h, t, _), s in zip(plan.inv_stages, inv):
        x = x.reshape(lead + (h, 2, t))
        u = x[..., 0, :]
        v = x[..., 1, :]
        a = u + v
        b = u - v
        x = torch.stack(
            [torch.where(a >= q, a - q, a), (torch.where(b < 0, b + q, b) * s) % q],
            dim=-2,
        )
    return (x.reshape(shape) * plan.n_inv) % q


def ntt_fwd_plain(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Centered coefficients -> centered int32 NTT values (bit-reversed
    order); the JAX package's ``ntt_fwd``."""
    F = plan.field
    return F.to_centered(ntt_fwd_u_plain(plan, F.to_unsigned(x)))


def ntt_inv_plain(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Centered NTT values (bit-reversed order) -> centered int32
    coefficients; the JAX package's ``ntt_inv``."""
    F = plan.field
    return F.to_centered(ntt_inv_u_plain(plan, F.to_unsigned(x)))


def _launch(plan: NTTPlan, x: torch.Tensor, inverse: bool, centered: bool,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of ``fct_ntt_centered`` (int32) or ``fct_ntt_u`` (int64)
    over the rows of ``x``'s trailing axis, into ``out`` (contiguous, 16-byte
    aligned, ``x``'s shape and type, not ``x``; for example pre-filled) or a
    new tensor."""
    d = plan.degree
    name = "ntt_centered" if centered else "ntt_u"
    if d < 64 or d > 1024 or d & (d - 1):
        raise ValueError(f"{name} kernel needs a power-of-two degree in [64, 1024], got {d}")
    if x.dim() == 0 or x.shape[-1] != d:
        raise ValueError(f"{name}: trailing axis of shape {tuple(x.shape)} != degree {d}")
    dtype = torch.int32 if centered else torch.int64
    x2 = x.reshape(-1, d).contiguous()
    kernels.require_cuda_tensor(x2, "x", dtype, 2)
    x2 = kernels.aligned(x2)
    (y,) = kernels.outputs(None if out is None else [out], [tuple(x.shape)], x.device, dtype)
    if y.data_ptr() % 16:
        raise ValueError(f"{name}: out must start on a 16-byte boundary")
    rows = x2.shape[0]
    if rows == 0:
        return y
    tw, tw_sh = plan.twiddles(inverse, x.device)
    lib = kernels.library()
    fn = lib.fct_ntt_centered if centered else lib.fct_ntt_u
    rc = fn(x2.data_ptr(), y.data_ptr(), rows, d, tw.data_ptr(), tw_sh.data_ptr(),
            int(inverse), plan.n_inv, plan.n_inv_shoup, plan.modulus, kernels.cuda_stream())
    kernels.LAUNCHES[name] += 1
    kernels.check_launch(rc, name)
    return y


def ntt_fwd_u(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of int64 residues in ``[0, q)`` along the trailing axis.
    CPU tensors: :func:`ntt_fwd_u_plain`; CUDA tensors: kernel ``ntt_u``,
    whose contract is canonical residues (every caller passes
    ``to_unsigned`` output), any leading shape."""
    if x.device.type == "cpu":
        return ntt_fwd_u_plain(plan, x)
    return _launch(plan, x, inverse=False, centered=False)


def ntt_inv_u(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of int64 residues in ``[0, q)``; dispatch as
    :func:`ntt_fwd_u`."""
    if x.device.type == "cpu":
        return ntt_inv_u_plain(plan, x)
    return _launch(plan, x, inverse=True, centered=False)


def ntt_fwd(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Centered int32 coefficients -> centered int32 NTT values
    (bit-reversed order).  CPU tensors: :func:`ntt_fwd_plain`; CUDA tensors
    (int32): kernel ``ntt_centered``."""
    if x.device.type == "cpu":
        return ntt_fwd_plain(plan, x)
    return _launch(plan, x, inverse=False, centered=True)


def ntt_inv(plan: NTTPlan, x: torch.Tensor) -> torch.Tensor:
    """Centered int32 NTT values -> centered int32 coefficients; dispatch as
    :func:`ntt_fwd`."""
    if x.device.type == "cpu":
        return ntt_inv_plain(plan, x)
    return _launch(plan, x, inverse=True, centered=True)


def negacyclic_poly_mult(plan: NTTPlan, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """INTT(NTT(f) ⊙ NTT(g)): the negacyclic product of coefficient-domain
    polynomials (centered or residues, same shape) on the trailing axis ->
    centered int32; the JAX package's ``negacyclic_poly_mult``.  On a CUDA
    tensor: one ``ntt_u`` launch for both operands, one for the inverse."""
    F = plan.field
    hat = ntt_fwd_u(plan, F.to_unsigned(torch.stack([f, g])))
    return F.to_centered(ntt_inv_u(plan, F.mont_mul(F.to_mont(hat[0]), hat[1])))
