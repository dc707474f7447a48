"""Reference-exact ``str()`` of verification keys and challenges.

The port's copy of the parts of the JAX package's ``interop/serial.py`` that
the tensor lifecycle needs: ``vk_str`` (``KeyBatch.vk_strs``) and
``challenge_str``, with their polynomial and matrix helpers, in pure Python
(the JAX package's C formatter is an optimisation of the same text).  The
reference hashes these strings and sorts signers by ``str(vk)``
(fusion/fusion.py:417, :586-589, :661-663), so the format is the wire
format; the device pipeline builds the same bytes from templates
(interop/device_serial.py).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

# wire-format constant: the reference's class path (algebra/matrices.py:40-41)
NTT_CLASS = "<class 'algebra.polynomials.PolynomialNTTRepresentation'>"


def _int_list(values) -> str:
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return "[" + ", ".join(map(str, values)) + "]"


def poly_ntt_str(params, values) -> str:
    """PolynomialNTTRepresentation repr (algebra/polynomials.py:257-258)."""
    return (
        f"PolynomialNTTRepresentation(modulus={params.modulus}, degree={params.degree}, "
        f"root={params.root}, inv_root={params.inv_root}, root_order={params.root_order}, "
        f"values={_int_list(values)})"
    )


def matrix_str(elem_class: str, rows: Iterable[Iterable[str]]) -> str:
    """GeneralMatrix repr around pre-rendered element reprs (matrices.py:40-41)."""
    body = "[" + ", ".join("[" + ", ".join(row) + "]" for row in rows) + "]"
    return f"GeneralMatrix(elem_class={elem_class}, matrix={body})"


def vk_str(params, vk: np.ndarray) -> str:
    """OneTimeVerificationKey repr (fusion.py:328-329).  ``vk`` is
    int32[2, degree] (left, right), each the single entry of a 1x1 NTT
    matrix."""
    vk = np.asarray(vk)
    left, right = (matrix_str(NTT_CLASS, [[poly_ntt_str(params, vk[k])]]) for k in (0, 1))
    return f"OneTimeVerificationKey(left_vk_hat={left}, right_vk_hat={right})"


def challenge_str(params, c_hat: np.ndarray) -> str:
    """SignatureChallenge repr (fusion.py:382-383).  ``c_hat`` is
    int32[degree], NTT domain."""
    return f"SignatureChallenge(c_hat={poly_ntt_str(params, np.asarray(c_hat))})"
