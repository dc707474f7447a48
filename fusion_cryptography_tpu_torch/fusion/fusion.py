"""Drop-in import surface for the reference's ``fusion.fusion`` module (its
public names), backed by the port's object API (interop/api.py).

``PREFIX_PARAMETERS`` is rebuilt from the port's parameter formulas and
carries the same keys/values as the reference table (fusion.py:71-141).
"""
from typing import Dict

from ..interop.api import (
    AggregationCoefficient,
    OneTimeKeyTuple,
    OneTimeSigningKey,
    OneTimeVerificationKey,
    Params,
    Signature,
    SignatureChallenge,
    aggregate,
    decode_bytes_to_agg_coefs,
    decode_bytes_to_polynomial_coefficients,
    fusion_setup,
    hash_ag,
    hash_ch,
    hash_message_to_int,
    hash_vk_and_int_to_bytes,
    hash_vks_and_ints_and_challs_to_bytes,
    keygen,
    parse_challenge,
    sign,
    verify,
)
from ..params import PRIME, _LEVELS, _dst, _xof_coef_bytes, _xof_shuffle_bytes

__all__ = [
    "PREFIX_PARAMETERS",
    "PRIME",
    "Params",
    "fusion_setup",
    "OneTimeSigningKey",
    "OneTimeVerificationKey",
    "OneTimeKeyTuple",
    "SignatureChallenge",
    "Signature",
    "AggregationCoefficient",
    "keygen",
    "sign",
    "aggregate",
    "verify",
    "hash_message_to_int",
    "hash_vk_and_int_to_bytes",
    "decode_bytes_to_polynomial_coefficients",
    "parse_challenge",
    "hash_ch",
    "hash_vks_and_ints_and_challs_to_bytes",
    "decode_bytes_to_agg_coefs",
    "hash_ag",
]


def _prefix_parameters() -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for secpar, c in _LEVELS.items():
        degree, rank = c["degree"], c["rank"]
        level_tag = 1 if secpar == 128 else 3
        inter = c["beta_sk"] * (1 + min(degree, c["omega_ch"]) * c["ch_bd"])
        beta_vf = c["capacity"] * min(degree, c["omega_ag"]) * c["ag_bd"] * inter
        out[secpar] = {
            "capacity": c["capacity"],
            "modulus": PRIME,
            "degree": degree,
            "root_order": 2 * degree,
            "root": c["root"],
            "inv_root": pow(c["root"], PRIME - 2, PRIME),
            "num_rows_pub_challenge": 1,
            "num_rows_sk": rank,
            "num_rows_vk": 1,
            "num_cols_pub_challenge": rank,
            "num_cols_sk": 1,
            "num_cols_vk": 1,
            "sign_pre_hash_dst": _dst(level_tag, 0),
            "sign_hash_dst": _dst(level_tag, 1),
            "agg_xof_dst": _dst(level_tag, 2),
            "beta_sk": c["beta_sk"],
            "beta_ch": 1,
            "beta_ag": 1,
            "omega_sk": degree,
            "omega_ch": c["omega_ch"],
            "omega_ag": c["omega_ag"],
            "beta_vf": beta_vf,
            "omega_vf": degree,
            "bytes_for_one_coef_bdd_by_beta_ch": _xof_coef_bytes(secpar, 1),
            "bytes_for_one_coef_bdd_by_beta_ag": _xof_coef_bytes(secpar, 1),
            "bytes_for_poly_shuffle": _xof_shuffle_bytes(secpar, degree),
        }
    return out


PREFIX_PARAMETERS: Dict[int, dict] = _prefix_parameters()
