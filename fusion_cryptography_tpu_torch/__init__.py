"""PyTorch / CUDA port of fusion_cryptography_tpu for NVIDIA Hopper GPUs.

Fusion is an aggregatable post-quantum lattice signature scheme (eprint
2023/303).  This package ports the grouped aggregate-verify path and the
on-device fleet build of the JAX package (``fusion_cryptography_tpu``, the
reference it is tested against) to PyTorch, with the TPU's Pallas kernels on
that path rewritten as CUDA kernels for ``sm_90a`` (``csrc/``).  It imports
neither JAX nor the JAX package.

Entry points::

    params = fusion_setup(256, seed)
    vks, msgs, aggs = build_fleet(params, n_groups, n_signers)  # on the card
    eq, norm_ok, weight_ok = verify_batch_device(params, vks, msgs, aggs)

The entry points run on the CUDA device unless given ``device="cpu"`` (or,
for the verify entry points, CPU tensors), and raise when there is no card.
Tensors on a CUDA device run the CUDA kernels (built by nvcc at first use);
tensors on the CPU run the kernels' plain torch versions.
"""
from .params import Params, fusion_setup, params_from_numpy
from .scheme.device_pipeline import derive_coeffs_device, verify_batch_device
from .scheme.device_setup import build_fleet

__all__ = [
    "Params",
    "fusion_setup",
    "params_from_numpy",
    "build_fleet",
    "verify_batch_device",
    "derive_coeffs_device",
]
