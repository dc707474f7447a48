"""Plain reference of the Fusion scheme for the benchmark's comparisons.

Written from the reference implementation's semantics (geometry-labs
``fusion/fusion.py``, ``algebra/*``), the wire format the frozen KAT corpus
pins, with Python ints, ``random``, ``hashlib`` and NumPy only.  It imports
nothing of the measured package, so a fault there cannot hide here.  Batches
of keys or groups are vectorized over their leading axis; the arithmetic is
exact (int64 residues, every product below 2**62).

Conventions: polynomials in the NTT domain are int64 arrays of centered
values (the reference's ``cent``), in the reference's bit-reversed order;
``vk`` is [2, d] (left, right); an aggregate or signature is [rank, d].
"""
from __future__ import annotations

import random
from dataclasses import dataclass, replace
from functools import lru_cache
from hashlib import sha3_256, shake_256
from math import ceil, log2
from typing import Sequence, Tuple

import numpy as np

PRIME = 2147465729
NTT_CLASS = "<class 'algebra.polynomials.PolynomialNTTRepresentation'>"

# reference fusion/fusion.py:17-37, per security level
LEVELS = {
    128: dict(degree=64, rank=195, capacity=1796, omega_ch=27, omega_ag=35, beta_sk=52,
              ch_bd=3, ag_bd=2, root=23584283, tag=1),
    256: dict(degree=256, rank=83, capacity=2818, omega_ch=60, omega_ag=60, beta_sk=52,
              ch_bd=1, ag_bd=1, root=3337519, tag=3),
}


@dataclass(frozen=True, eq=False)
class Params:
    secpar: int
    seed: int
    modulus: int
    degree: int
    rank: int
    capacity: int
    root: int
    inv_root: int
    beta_sk: int
    beta_vf: int
    omega_ch: int
    omega_ag: int
    omega_vf: int
    pre_dst: bytes
    ch_dst: bytes
    ag_dst: bytes
    public_challenge: np.ndarray  # int64 [rank, d], centered NTT values

    beta_ch: int = 1  # the reference's runtime bounds are 1 at both levels
    beta_ag: int = 1
    # False: every modular product in float64, the precision a faster
    # implementation might be tempted by -- the benchmark's control, which
    # must come out wrong
    exact: bool = True

    @property
    def root_order(self) -> int:
        return 2 * self.degree


@lru_cache(maxsize=8)
def setup(secpar: int, seed: int) -> Params:
    """``fusion_setup(secpar, seed)``: an integer seed re-seeds CPython's
    generator for every matrix entry, so all rank entries of the public
    challenge are one polynomial (reference polynomials.py:470-488)."""
    c = LEVELS[secpar]
    d, rank = c["degree"], c["rank"]
    beta_vf = (c["capacity"] * min(d, c["omega_ag"]) * c["ag_bd"]
               * c["beta_sk"] * (1 + min(d, c["omega_ch"]) * c["ch_bd"]))
    rng = random.Random(seed)
    half = PRIME // 2
    one = np.array([rng.randrange(PRIME) - half for _ in range(d)], dtype=np.int64)
    tag = c["tag"]
    return Params(secpar=secpar, seed=seed, modulus=PRIME, degree=d, rank=rank,
                  capacity=c["capacity"], root=c["root"], inv_root=pow(c["root"], PRIME - 2, PRIME),
                  beta_sk=c["beta_sk"], beta_vf=beta_vf, omega_ch=c["omega_ch"],
                  omega_ag=c["omega_ag"], omega_vf=d, pre_dst=bytes([tag, 0]),
                  ch_dst=bytes([tag, 1]), ag_dst=bytes([tag, 2]),
                  public_challenge=np.broadcast_to(one, (rank, d)).copy())


# ---------------------------------------------------------------- arithmetic

def centered(x: np.ndarray, q: int = PRIME) -> np.ndarray:
    y = np.mod(x, q)
    return np.where(y > q // 2, y - q, y)


def control(params: Params) -> Params:
    """``params`` with the products computed in float64 (the control)."""
    return replace(params, exact=False)


def mulmod(params: Params, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b mod q of residues in [0, q): exact in int64, or rounded
    through float64 for the control."""
    q = params.modulus
    if params.exact:
        return a * b % q
    return np.mod(np.asarray(a, dtype=np.float64) * b, q).astype(np.int64) % q


def _bitrev(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    return np.array([int(format(i, f"0{k}b")[::-1], 2) if k else 0 for i in range(n)])


@lru_cache(maxsize=8)
def _twiddles(q: int, d: int, root: int) -> Tuple[np.ndarray, np.ndarray, int]:
    inv_root = pow(root, q - 2, q)
    idx = _bitrev(d)
    brp = np.array([pow(root, int(i), q) for i in idx], dtype=np.int64)
    brp_inv = np.array([pow(inv_root, int(i), q) for i in idx], dtype=np.int64)
    return brp, brp_inv, pow(d, q - 2, q)


def ntt(params: Params, x: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT over the last axis (Cooley-Tukey, standard
    order in, bit-reversed out; reference algebra/ntt.py:216-291) -> centered."""
    q, d = params.modulus, params.degree
    brp, _, _ = _twiddles(q, d, params.root)
    a = np.mod(np.asarray(x, dtype=np.int64), q)
    lead = a.shape[:-1]
    m, t = 1, d
    while m < d:
        t //= 2
        a = a.reshape(lead + (m, 2, t))
        u, v = a[..., 0, :], mulmod(params, a[..., 1, :], brp[m:2 * m, None])
        a = np.stack([(u + v) % q, (u - v) % q], axis=-2).reshape(lead + (d,))
        m *= 2
    return centered(a, q)


def intt(params: Params, x: np.ndarray) -> np.ndarray:
    """Inverse negacyclic NTT over the last axis (Gentleman-Sande,
    bit-reversed in, standard out; reference algebra/ntt.py:294-377) ->
    centered coefficients."""
    q, d = params.modulus, params.degree
    _, brp_inv, n_inv = _twiddles(q, d, params.root)
    a = np.mod(np.asarray(x, dtype=np.int64), q)
    lead = a.shape[:-1]
    h, t = d // 2, 1
    while h >= 1:
        a = a.reshape(lead + (h, 2, t))
        u, v = a[..., 0, :], a[..., 1, :]
        a = np.stack([(u + v) % q, mulmod(params, (u - v) % q, brp_inv[h:2 * h, None])],
                     axis=-2).reshape(lead + (d,))
        h //= 2
        t *= 2
    return centered(mulmod(params, a, n_inv), q)


def mul(params: Params, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pointwise product of NTT values mod q, as residues in [0, q)."""
    q = params.modulus
    return mulmod(params, np.mod(a, q), np.mod(b, q))


# ---------------------------------------------------------------- wire format

def poly_str(params: Params, values) -> str:
    """PolynomialNTTRepresentation repr (reference polynomials.py:257-258)."""
    vals = ", ".join(map(str, np.asarray(values).tolist()))
    return (f"PolynomialNTTRepresentation(modulus={params.modulus}, degree={params.degree}, "
            f"root={params.root}, inv_root={params.inv_root}, root_order={params.root_order}, "
            f"values=[{vals}])")


def matrix_str(params: Params, rows) -> str:
    """GeneralMatrix repr of NTT polynomials, ``rows`` [rows, cols, d]."""
    body = ", ".join("[" + ", ".join(poly_str(params, p) for p in row) + "]" for row in rows)
    return f"GeneralMatrix(elem_class={NTT_CLASS}, matrix=[{body}])"


def vk_str(params: Params, vk) -> str:
    vk = np.asarray(vk)
    return (f"OneTimeVerificationKey(left_vk_hat={matrix_str(params, [[vk[0]]])}, "
            f"right_vk_hat={matrix_str(params, [[vk[1]]])})")


def sk_str(params: Params, seed: int, sk_hat) -> str:
    """sk_hat [2, rank, d]."""
    sk_hat = np.asarray(sk_hat)
    left = matrix_str(params, [[r] for r in sk_hat[0]])
    right = matrix_str(params, [[r] for r in sk_hat[1]])
    return f"OneTimeSigningKey(seed={seed}, left_sk_hat={left}, right_sk_hat={right})"


def sig_str(params: Params, sig) -> str:
    return f"Signature(signature_hat={matrix_str(params, [[r] for r in np.asarray(sig)])})"


def challenge_str(params: Params, c_hat) -> str:
    return f"SignatureChallenge(c_hat={poly_str(params, c_hat)})"


def params_str(params: Params) -> str:
    """The reference's Params repr (fusion.py:284-285)."""
    p = params
    pub = matrix_str(p, [list(p.public_challenge)])
    coef_bytes = ceil(ceil(log2(3) / 8) + p.secpar / 8)
    shuffle = p.degree * ceil(ceil(log2(p.degree) / 8) + p.secpar / 8)
    return (
        f"Params(secpar={p.secpar}, capacity={p.capacity}, modulus={p.modulus}, "
        f"degree={p.degree}, root_order={p.root_order}, root={p.root}, inv_root={p.inv_root}, "
        f"num_rows_pub_challenge=1, num_rows_sk={p.rank}, num_rows_vk=1, "
        f"num_cols_pub_challenge={p.rank}, num_cols_sk=1, num_cols_vk=1, beta_sk={p.beta_sk}, "
        f"beta_ch={p.beta_ch}, beta_ag={p.beta_ag}, beta_vf={p.beta_vf}, "
        f"omega_sk={p.degree}, omega_ch={p.omega_ch}, omega_ag={p.omega_ag}, "
        f"omega_vf={p.omega_vf}, public_challenge={pub}, sign_pre_hash_dst={p.pre_dst!r}, "
        f"sign_hash_dst={p.ch_dst!r}, agg_xof_dst={p.ag_dst!r}, "
        f"bytes_for_one_coef_bdd_by_beta_ch={coef_bytes}, "
        f"bytes_for_one_coef_bdd_by_beta_ag={coef_bytes}, bytes_for_poly_shuffle={shuffle})"
    )


# ---------------------------------------------------------------- hashing

def prehash(params: Params, message: str) -> int:
    """SHA3-256(dst + "," + message) as a little-endian integer (fusion.py:405-409)."""
    digest = sha3_256(params.pre_dst + b"," + message.encode("utf-8")).digest()
    return int.from_bytes(digest, "little")


def _coef_index_bytes(params: Params, bound: int) -> Tuple[int, int]:
    bpc = ceil((log2(bound) + 1 + params.secpar) / 8)
    bpi = ceil((log2(params.degree) + params.secpar) / 8)
    return bpc, bpi


def challenge_len(params: Params) -> int:
    """Bytes of the challenge XOF (fusion.py:541-550)."""
    d, w = params.degree, params.omega_ch
    bpc, bpi = _coef_index_bytes(params, max(1, min(params.modulus // 2, params.beta_ch)))
    return ceil(w / 8) + bpc * min(d, w) + d * bpi


def agg_block_len(params: Params) -> int:
    """Bytes of one signer's block of the aggregation XOF (fusion.py:579-585)."""
    w = params.omega_ag
    bpc, bpi = _coef_index_bytes(params, max(1, min(params.modulus // 2, params.beta_ag)))
    return ceil(w / 8) + (bpc + bpi) * w


def decode(params: Params, streams: np.ndarray, norm_bound: int, weight_bound: int) -> np.ndarray:
    """XOF bytes uint8[R, L] -> coefficients int64[R, d] (fusion.py:422-481):
    signums from the big-endian signum bytes (bit i of the integer is signum
    i), magnitudes ``block % bound + 1``, then the partial Fisher-Yates from
    i = d-1 down to ``weight_bound + 1``, each index the big-endian integer
    of the next bytes of the stream (fewer, or none, past its end) mod i+1."""
    d = params.degree
    b = np.asarray(streams, dtype=np.uint8)
    R, L = b.shape
    w = weight_bound
    bound = max(1, min(params.modulus // 2, norm_bound))
    bpc, bpi = _coef_index_bytes(params, bound)
    sb = ceil(w / 8)
    if L < sb + (bpc + bpi) * w:
        raise ValueError(f"too few bytes to decode: {L}")
    i = np.arange(w)
    bits = (b[:, sb - 1 - i // 8] >> (i % 8)) & 1
    signs = 2 * bits.astype(np.int64) - 1
    if bound == 1:
        mags = np.ones((R, w), dtype=np.int64)
    else:
        blocks = b[:, sb:sb + w * bpc].reshape(R, w, bpc)
        mags = np.array([[int.from_bytes(bytes(blk), "big") % bound + 1 for blk in row]
                         for row in blocks], dtype=np.int64).reshape(R, w)
    coefs = np.zeros((R, d), dtype=np.int64)
    coefs[:, :w] = mags * signs
    off = sb + w * bpc
    rows = np.arange(R)
    if max(1, min(d, w)) < d:
        for pos in range(d - 1, w, -1):
            m = pos + 1
            chunk = b[:, off:min(off + bpi, L)].astype(np.int64)
            off += bpi
            # the big-endian integer mod m, from each byte's weight 256**k mod m
            weights = np.array([pow(256, k, m) for k in range(chunk.shape[1] - 1, -1, -1)],
                               dtype=np.int64)
            j = chunk @ weights % m
            ci = coefs[:, pos].copy()
            coefs[:, pos] = coefs[rows, j]
            coefs[rows, j] = ci
    return coefs


def challenges(params: Params, vk_strs: Sequence[str], pre_ints: Sequence[int]) -> np.ndarray:
    """``hash_ch`` of each (str(vk), prehash): SHAKE256(dst + "," + str(vk) +
    "," + str(prehash)) decoded and transformed -> c_hat int64[B, d]."""
    n = challenge_len(params)
    raw = b"".join(shake_256(params.ch_dst + b"," + v.encode() + b"," + str(i).encode()).digest(n)
                   for v, i in zip(vk_strs, pre_ints))
    streams = np.frombuffer(raw, dtype=np.uint8).reshape(len(vk_strs), n)
    return ntt(params, decode(params, streams, params.beta_ch, params.omega_ch))


def alphas(params: Params, vk_strs: Sequence[str], pre_ints: Sequence[int],
           c_hats: np.ndarray, n_signers: int) -> np.ndarray:
    """``hash_ag`` of groups of ``n_signers`` sorted signers, given flat ->
    alpha_hat int64[G, N, d]: for each group SHAKE256(dst + "," +
    str(list(zip(keys, prehashes, challenges)))), one block a signer
    (fusion.py:573-629)."""
    N = n_signers
    block = agg_block_len(params)
    raw = []
    for lo in range(0, len(vk_strs), N):
        body = "[" + ", ".join(f"({v}, {i}, {challenge_str(params, c)})" for v, i, c in
                               zip(vk_strs[lo:lo + N], pre_ints[lo:lo + N], c_hats[lo:lo + N]))
        raw.append(shake_256(params.ag_dst + b"," + (body + "]").encode("utf-8")).digest(N * block))
    streams = np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(-1, block)
    al = ntt(params, decode(params, streams, params.beta_ag, params.omega_ag))
    return al.reshape(-1, N, params.degree)


# ---------------------------------------------------------------- the scheme

def sample_short(params: Params, seed: int) -> np.ndarray:
    """Short coefficients int64[d] from ``seed`` (polynomials.py:436-467):
    ±(1 + randrange(bound)), then a full Fisher-Yates pass when fewer than
    d are nonzero."""
    rng = random.Random(seed)
    d = params.degree
    num = d  # omega_sk = degree
    bound = max(0, min(params.modulus // 2, params.beta_sk))
    coefs = [(1 + rng.randrange(bound)) * (1 - 2 * rng.randrange(2)) for _ in range(num)]
    coefs += [0] * (d - num)
    if num < d:
        for i in range(d - 1, 0, -1):
            j = rng.randrange(i + 1)
            coefs[i], coefs[j] = coefs[j], coefs[i]
    return np.array(coefs, dtype=np.int64)


def keygen_many(params: Params, seeds: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(sk_hat int64[K, 2, rank, d], vk int64[K, 2, d]) of each seed
    (fusion.py:338-373): left from seed, right from seed + 1, every rank
    entry re-seeded alike; vk = A·sk summed over the rank."""
    sk = np.stack([[sample_short(params, s), sample_short(params, s + 1)] for s in seeds])
    K, rank, d = len(seeds), params.rank, params.degree
    # the rank entries are one polynomial, and the transform acts on each alone
    sk_hat = np.broadcast_to(ntt(params, sk[:, :, None, :]), (K, 2, rank, d))
    vk = centered(mul(params, params.public_challenge, sk_hat).sum(axis=2), params.modulus)
    return sk_hat, vk


def keygen(params: Params, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`keygen_many` of one seed -> (sk_hat [2, rank, d], vk [2, d])."""
    sk_hat, vk = keygen_many(params, [seed])
    return sk_hat[0], vk[0]


def sign_many(params: Params, sk_hat: np.ndarray, vk: np.ndarray,
              messages: Sequence[str]) -> np.ndarray:
    """sig = sk_l ⊙ c + sk_r for every rank entry (fusion.py:534-557) of K
    keys, key k over ``messages[k]`` -> int64[K, rank, d] centered."""
    c_hat = challenges(params, [vk_str(params, v) for v in vk],
                       [prehash(params, m) for m in messages])
    return centered(mul(params, c_hat[:, None], sk_hat[:, 0]) + np.mod(sk_hat[:, 1], params.modulus),
                    params.modulus)


def sign(params: Params, sk_hat: np.ndarray, vk: np.ndarray, message: str) -> np.ndarray:
    """:func:`sign_many` of one key -> int64[rank, d]."""
    return sign_many(params, sk_hat[None], vk[None], [message])[0]


def aggregate_groups(params: Params, vks: np.ndarray, messages: Sequence[Sequence[str]],
                     sigs: np.ndarray) -> np.ndarray:
    """Aggregate each of G groups in str(vk) order with the alphas
    (fusion.py:655-677): vks int[G, N, 2, d], messages G lists of N, sigs
    int[G, N, rank, d] -> int64[G, rank, d] centered."""
    G, N = vks.shape[0], vks.shape[1]
    strs = [[vk_str(params, vks[g, k]) for k in range(N)] for g in range(G)]
    orders = [sorted(range(N), key=lambda k, g=g: strs[g][k]) for g in range(G)]
    s = [strs[g][k] for g in range(G) for k in orders[g]]
    pre = [prehash(params, messages[g][k]) for g in range(G) for k in orders[g]]
    al = alphas(params, s, pre, challenges(params, s, pre), N)
    s_sigs = np.stack([sigs[g, orders[g]] for g in range(G)])
    return centered(mul(params, al[:, :, None], s_sigs).sum(axis=1), params.modulus)


def aggregate(params: Params, vks: Sequence[np.ndarray], messages: Sequence[str],
              sigs: Sequence[np.ndarray]) -> np.ndarray:
    """:func:`aggregate_groups` of one group -> int64[rank, d]."""
    return aggregate_groups(params, np.stack(vks)[None], [list(messages)], np.stack(sigs)[None])[0]


def make_groups(params: Params, seeds: Sequence[int], messages: Sequence[Sequence[str]]
                ) -> Tuple[np.ndarray, list, np.ndarray]:
    """G valid groups of N signers made by keygen, sign and aggregate: key
    n of group g from ``seeds[g][n]`` signs ``messages[g][n]`` -> (vks
    int64[G, N, 2, d] sorted within each group by str(vk), as a verifier
    takes them, messages G lists of N in that order, aggregates int64[G,
    rank, d])."""
    G, N = len(seeds), len(seeds[0])
    flat = [m for group in messages for m in group]
    sk_hat, vk = keygen_many(params, [s for group in seeds for s in group])
    sigs = sign_many(params, sk_hat, vk, flat).reshape(G, N, params.rank, params.degree)
    vks = vk.reshape(G, N, 2, params.degree)
    aggs = aggregate_groups(params, vks, messages, sigs)
    strs = [[vk_str(params, vks[g, k]) for k in range(N)] for g in range(G)]
    orders = [sorted(range(N), key=lambda k, g=g: strs[g][k]) for g in range(G)]
    return (np.stack([vks[g, orders[g]] for g in range(G)]),
            [[messages[g][k] for k in orders[g]] for g in range(G)], aggs)


def verify_groups(params: Params, vks: np.ndarray, messages: Sequence[Sequence[str]],
                  aggs: np.ndarray) -> np.ndarray:
    """The reference verify (fusion.py:680-728) of G groups: vks int[G, N, 2,
    d] in any order within a group, messages G lists of N, aggs int[G, rank, d]
    -> bool[G, 3] (target == observed, norm within beta_vf, weight within
    omega_vf).  Signers are sorted by str(vk), stably, as the reference does."""
    G, N = vks.shape[0], vks.shape[1]
    q = params.modulus
    if N > params.capacity:
        raise ValueError("too many keys")
    strs = [[vk_str(params, vks[g, k]) for k in range(N)] for g in range(G)]
    orders = [sorted(range(N), key=lambda k, g=g: strs[g][k]) for g in range(G)]
    s_vks = np.stack([vks[g, orders[g]] for g in range(G)]).astype(np.int64)
    s_strs = [strs[g][k] for g in range(G) for k in orders[g]]
    pre = [prehash(params, messages[g][k]) for g in range(G) for k in orders[g]]
    c_flat = challenges(params, s_strs, pre)
    al = alphas(params, s_strs, pre, c_flat, N)
    c_hat = c_flat.reshape(G, N, -1)
    t = (mul(params, c_hat, s_vks[:, :, 0]) + np.mod(s_vks[:, :, 1], q)) % q
    target = mul(params, al, t).sum(axis=1) % q
    aggs = np.asarray(aggs, dtype=np.int64)
    observed = mul(params, params.public_challenge[None], aggs).sum(axis=1) % q
    coefs = intt(params, aggs)
    norm = np.abs(coefs).max(axis=(1, 2))
    weight = (coefs != 0).sum(axis=2).max(axis=1)
    return np.stack([(target == observed).all(axis=1),
                     norm <= min(params.beta_vf, 2**31 - 1),
                     weight <= params.omega_vf], axis=1)
