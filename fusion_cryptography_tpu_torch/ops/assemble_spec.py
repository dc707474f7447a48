"""Generic preimage assembly from any ``PreimageSpec``: a CUDA kernel and
its plain version.

Port of the JAX package's ``ops/assemble_pallas.py`` (TPU kernel ``_build``)
in its ``output="words"`` mode, the one a word-carrier pipeline consumes:
the spec's consts, decimal cells of ``values`` and ragged extras,
concatenated lane by lane into packed words int32[Ww, B] (uint32 bit
patterns, batch minor, zero past each lane's length up to the full width)
and the lengths int32[B].

The kernel is in ``csrc/assemble_spec.cu`` and reads the spec's op table
(``interop/device_serial.spec_table``).  On a CUDA tensor
:func:`assemble_spec` launches it (or raises); on a CPU tensor it runs the
plain version, ``device_serial.assemble_chunks_words``.  The TPU kernel's
rule that B be a multiple of 128 is a tile rule of the TPU and is not
carried over.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels
from ..interop import device_serial as ds
from . import ragged_words as rw
from .upload import upload


def assemble_spec(
    spec: ds.PreimageSpec,
    values: Optional[torch.Tensor] = None,
    extras: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    extra_bounds: Optional[Sequence[Tuple[int, int]]] = None,
    pad_words: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate ``spec`` for a batch (kernel ``assemble_spec``).

    values int32[num_numbers, B] centered (None when the spec has no
    numbers); extras (int32[ceil(width/4), B] words zero past the length,
    int32[B] lengths) pairs, which may be strided views (for example column
    slices of one buffer); extra_bounds optional static (min_len, max_len)
    per extra, metadata that the kernel does not need.  Returns (buf
    int32[Ww, B], total int32[B]) with Ww = ``pad_words`` or
    ceil(out_max / 4); content past Ww words is dropped, the lengths count
    it."""
    extras = list(extras)
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    if extra_bounds is not None and len(extra_bounds) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extra bounds, got {len(extra_bounds)}")
    if (values is None) != (spec.num_numbers == 0):
        raise ValueError(f"spec needs int32[{spec.num_numbers}, B] values")
    if values is None and not extras:
        raise ValueError("a spec without numbers or extras has no batch")
    lead = values if values is not None else extras[0][0]
    if lead.device.type == "cpu":
        return ds.assemble_chunks_words(spec, values, extras, extra_bounds, pad_words)
    return _assemble_spec_launch(spec, values, extras, pad_words)


def _assemble_spec_launch(spec: ds.PreimageSpec, values: Optional[torch.Tensor],
                          extras: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                          pad_words: Optional[int] = None,
                          outs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel ``assemble_spec`` (arguments as
    :func:`assemble_spec`'s, checked there) into ``outs`` (int32[Ww, B] and
    int32[B] on the card) or new tensors: chip_smoke and the tests write
    onto outputs they pre-fill."""
    lead = values if values is not None else extras[0][0]
    dev = lead.device
    B = lead.shape[-1]
    if values is not None:
        kernels.require_cuda_tensor(values, "values", torch.int32, 2)
        if tuple(values.shape) != (spec.num_numbers, B):
            raise ValueError(f"values: expected int32[{spec.num_numbers}, B], "
                             f"got {tuple(values.shape)}")
    rows = []
    for e, (eb, el) in enumerate(extras):
        want = rw.words_for(spec.extra_widths[e])
        if (eb.device != dev or el.device != dev or eb.dtype != torch.int32
                or el.dtype != torch.int32 or tuple(eb.shape) != (want, B)
                or tuple(el.shape) != (B,)):
            raise ValueError(
                f"extra {e}: expected int32[{want}, {B}] words and int32[{B}] lengths on "
                f"{dev}, got {eb.dtype}{tuple(eb.shape)} on {eb.device} and "
                f"{el.dtype}{tuple(el.shape)} on {el.device}")
        rows.append([eb.data_ptr(), eb.stride(0), eb.stride(1), el.data_ptr(), el.stride(0),
                     want])
    # the pointer table goes over from pinned memory, asynchronously on the
    # stream (a blocking copy would sync the device)
    table = upload(rows or [[0] * 6], dev, torch.int64)
    prog = ds.spec_table(spec, pad_words)
    ops, pool = prog.on(dev)
    (width,) = prog.widths
    out, total = kernels.outputs(outs, ((width, B), (B,)), dev)
    rc = kernels.library().fct_assemble_spec(
        ops.data_ptr(), ops.shape[0], pool.data_ptr(),
        None if values is None else values.data_ptr(),
        0 if values is None else values.stride(0), table.data_ptr(), B, out.data_ptr(),
        width, total.data_ptr(), kernels.cuda_stream(),
    )
    kernels.LAUNCHES["assemble_spec"] += 1
    kernels.check_launch(rc, "assemble_spec")
    return out, total
