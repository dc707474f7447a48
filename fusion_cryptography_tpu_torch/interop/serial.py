"""Reference-exact ``str()`` serialization of tensor-backed scheme objects.

The port's copy of the JAX package's ``interop/serial.py``, in pure Python
(the JAX package's C formatter is an optimisation of the same text).  The
reference hashes object-graph ``repr`` strings straight into SHAKE256
(fusion/fusion.py:417, :586-589), sorts signer tuples by ``str(vk)``
(fusion.py:661-663), and the KAT corpus freezes those exact strings, so the
serialization format *is* the wire format.  The device pipeline builds the
same bytes from templates (interop/device_serial.py).

Format notes (pinned by the KAT corpus):
* polynomial reprs:   PolynomialNTTRepresentation(modulus=..., degree=...,
  root=..., inv_root=..., root_order=..., values=[v0, v1, ...])
  (algebra/polynomials.py:92-93, :257-258);
* matrix reprs embed the *reference's* class path, e.g.
  ``elem_class=<class 'algebra.polynomials.PolynomialNTTRepresentation'>``
  (algebra/matrices.py:40-41) — wire-format constants, not imports;
* byte strings render via Python's native ``bytes.__repr__`` (fusion.py:285).

Values may be numpy arrays, torch tensors (on any device) or int lists.
"""
from __future__ import annotations

import warnings
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

NTT_CLASS = "<class 'algebra.polynomials.PolynomialNTTRepresentation'>"
COEF_CLASS = "<class 'algebra.polynomials.PolynomialCoefficientRepresentation'>"


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _int_list(values) -> str:
    if isinstance(values, (np.ndarray, torch.Tensor)):
        values = values.tolist()
    return "[" + ", ".join(map(str, values)) + "]"


def poly_ntt_str(modulus: int, degree: int, root: int, inv_root: int, root_order: int,
                 values) -> str:
    """PolynomialNTTRepresentation repr (algebra/polynomials.py:257-258)."""
    return (
        f"PolynomialNTTRepresentation(modulus={modulus}, degree={degree}, root={root}, "
        f"inv_root={inv_root}, root_order={root_order}, values={_int_list(values)})"
    )


def poly_coef_str(modulus: int, degree: int, root: int, inv_root: int, root_order: int,
                  coefficients) -> str:
    """PolynomialCoefficientRepresentation repr (algebra/polynomials.py:92-93)."""
    return (
        f"PolynomialCoefficientRepresentation(modulus={modulus}, degree={degree}, root={root}, "
        f"inv_root={inv_root}, root_order={root_order}, "
        f"coefficients={_int_list(coefficients)})"
    )


def _params_poly_str(params, values) -> str:
    return poly_ntt_str(params.modulus, params.degree, params.root, params.inv_root,
                        params.root_order, values)


def matrix_str(elem_class: str, rows: Iterable[Iterable[str]]) -> str:
    """GeneralMatrix repr around pre-rendered element reprs (matrices.py:40-41)."""
    body = "[" + ", ".join("[" + ", ".join(row) + "]" for row in rows) + "]"
    return f"GeneralMatrix(elem_class={elem_class}, matrix={body})"


def ntt_matrix_str(params, tensor, rows: int, cols: int) -> str:
    """Render an int32[rows, cols, degree] NTT-domain tensor as a GeneralMatrix
    of PolynomialNTTRepresentation reprs."""
    t = _host(tensor).reshape(rows, cols, params.degree)
    return matrix_str(
        NTT_CLASS, ((_params_poly_str(params, t[i, j]) for j in range(cols)) for i in range(rows))
    )


def params_str(params) -> str:
    """Reference Params repr (fusion/fusion.py:284-285)."""
    pub = ntt_matrix_str(params, params.public_challenge[None, :, :], 1, params.rank)
    return (
        f"Params(secpar={params.secpar}, capacity={params.capacity}, modulus={params.modulus}, "
        f"degree={params.degree}, root_order={params.root_order}, root={params.root}, "
        f"inv_root={params.inv_root}, num_rows_pub_challenge={params.num_rows_pub_challenge}, "
        f"num_rows_sk={params.num_rows_sk}, num_rows_vk={params.num_rows_vk}, "
        f"num_cols_pub_challenge={params.num_cols_pub_challenge}, num_cols_sk={params.num_cols_sk}, "
        f"num_cols_vk={params.num_cols_vk}, beta_sk={params.beta_sk}, beta_ch={params.beta_ch}, "
        f"beta_ag={params.beta_ag}, beta_vf={params.beta_vf}, omega_sk={params.omega_sk}, "
        f"omega_ch={params.omega_ch}, omega_ag={params.omega_ag}, omega_vf={params.omega_vf}, "
        f"public_challenge={pub}, sign_pre_hash_dst={params.sign_pre_hash_dst!r}, "
        f"sign_hash_dst={params.sign_hash_dst!r}, agg_xof_dst={params.agg_xof_dst!r}, "
        f"bytes_for_one_coef_bdd_by_beta_ch={params.bytes_for_one_coef_bdd_by_beta_ch}, "
        f"bytes_for_one_coef_bdd_by_beta_ag={params.bytes_for_one_coef_bdd_by_beta_ag}, "
        f"bytes_for_poly_shuffle={params.bytes_for_poly_shuffle})"
    )


def vk_str(params, vk) -> str:
    """OneTimeVerificationKey repr (fusion.py:328-329).  ``vk`` is
    int32[2, degree] (left, right), each the single entry of a 1x1 NTT
    matrix."""
    vk = _host(vk)
    left, right = (ntt_matrix_str(params, vk[k], 1, 1) for k in (0, 1))
    return f"OneTimeVerificationKey(left_vk_hat={left}, right_vk_hat={right})"


def _canonical_lengths(vals: np.ndarray) -> np.ndarray:
    """len(str(v)) of each int64 value below 10**18."""
    p10 = 10 ** np.arange(1, 19, dtype=np.int64)
    return 1 + (np.abs(vals)[..., None] >= p10).sum(-1) + (vals < 0)


def vk_values(params, reprs: Sequence[str]) -> np.ndarray:
    """The vks int32[B, 2, degree] whose :func:`vk_str` are ``reprs``;
    raises ValueError on a repr that is not the ``str()`` of a vk of
    ``params`` with int32 values.

    The text around the two value lists must equal ``vk_str``'s; each list
    must hold ``degree`` ASCII decimals joined by ", ", which numpy parses
    in one pass.  A decimal that is not ``str()`` of its value (a sign,
    a leading zero, a space) is longer than that, so the lists' lengths
    equal the canonical ones only if every decimal is canonical."""
    d, B = params.degree, len(reprs)
    head, mid, tail = vk_str(params, np.zeros((2, d))).split("values=[")
    mid, tail = mid[mid.index("]"):], tail[tail.index("]"):]
    lists = []
    for b, r in enumerate(reprs):
        parts = r.split("values=[")
        ok = len(parts) == 3 and parts[0] == head
        if ok:
            (left, rest_l), (right, rest_r) = ((p[:p.find("]")], p[p.find("]"):])
                                               for p in parts[1:])
            ok = (rest_l == mid and rest_r == tail and left.isascii() and right.isascii()
                  and left.count(", ") == d - 1 and right.count(", ") == d - 1)
        if not ok:
            raise ValueError(f"vk repr {b} is not the str() of a verification key of these "
                             f"parameters: {r[:80]!r}...")
        lists += [left, right]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)  # text left unparsed
            vals = np.fromstring(", ".join(lists), dtype=np.int64, sep=", ")
    except (DeprecationWarning, ValueError):
        vals = np.zeros(0, dtype=np.int64)
    where = "a vk repr"
    if vals.size == 2 * d * B:
        vals = vals.reshape(B, 2, d)
        lens = np.array([len(t) for t in lists], dtype=np.int64).reshape(B, 2)
        good = ((_canonical_lengths(vals).sum(-1) + 2 * (d - 1) == lens).all(-1)
                & (vals >= -2**31).all((1, 2)) & (vals < 2**31).all((1, 2)))
        if good.all():
            return vals.astype(np.int32)
        where = f"vk repr {int(np.argmin(good))}"
    raise ValueError(f"{where} is not the str() of a verification key of these parameters")


def sk_str(params, seed: Optional[int], sk_hat) -> str:
    """OneTimeSigningKey repr (fusion.py:313-314).  ``sk_hat`` is
    int32[2, rank, degree] NTT-domain (left, right), rank x 1 matrices."""
    sk_hat = _host(sk_hat)
    left = ntt_matrix_str(params, sk_hat[0], params.rank, 1)
    right = ntt_matrix_str(params, sk_hat[1], params.rank, 1)
    return f"OneTimeSigningKey(seed={seed}, left_sk_hat={left}, right_sk_hat={right})"


def sig_str(params, sig) -> str:
    """Signature repr (fusion.py:398-399).  ``sig`` is int32[rank, degree]."""
    return f"Signature(signature_hat={ntt_matrix_str(params, sig, params.rank, 1)})"


def challenge_str(params, c_hat) -> str:
    """SignatureChallenge repr (fusion.py:382-383).  ``c_hat`` is
    int32[degree], NTT domain."""
    return f"SignatureChallenge(c_hat={_params_poly_str(params, _host(c_hat))})"


def agg_coef_str(params, alpha_hat) -> str:
    """AggregationCoefficient repr (fusion.py:566-567)."""
    return f"AggregationCoefficient(alpha_hat={_params_poly_str(params, _host(alpha_hat))})"


def keytuple_str(params, seed: Optional[int], sk_hat, vk) -> str:
    """str((sk, vk)) — the tuple repr the KAT generator feeds into the
    aggregation XOF when it passes key *tuples* instead of vks
    (KATs/generate_KAT_values.py:120-133)."""
    return f"({sk_str(params, seed, sk_hat)}, {vk_str(params, vk)})"


def zip_triples_str(vk_strs: Sequence[str], prehashed: Sequence[int],
                    chall_strs: Sequence[str]) -> str:
    """str(list(zip(keys, prehashed_messages, challenges))) — the aggregation XOF
    preimage body (fusion.py:586-589)."""
    parts: List[str] = [
        f"({k}, {i}, {c})" for k, i, c in zip(vk_strs, prehashed, chall_strs)
    ]
    return "[" + ", ".join(parts) + "]"
