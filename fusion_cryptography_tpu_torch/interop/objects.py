"""Object-level compatibility layer: the reference's public classes, on tensors.

The port of the JAX package's ``interop/objects.py``.  Users of the
reference library (``algebra.polynomials``, ``algebra.matrices``) get the same
class names, constructor signatures, operator algebra, validation errors
and — critically — the same ``str``/``repr`` wire format (the hash pipeline
serializes through it, fusion/fusion.py:417).

A polynomial's ``coefficients`` or ``values`` are an int64 tensor[degree] on
a device: constructors and samplers take a list of ints (as the reference
does) or an integer tensor, and ``device=None``, meaning the card
(``device="cpu"`` for the CPU; a tensor keeps its device).  The results of
an operation live on the device of its left operand.  Products and
transforms go through ``ops/ntt``: on a CUDA tensor the NTT kernels
(``ntt_u`` for the negacyclic product, ``ntt_centered`` for ``transform``),
whose degrees are the powers of two from 64 to 1024; on the CPU their plain
versions.  Validation uses the cached primitive-root check of
``ops/numtheory`` instead of the reference's O(root_order) loop.

The classes masquerade as ``algebra.polynomials.*`` via ``__module__`` so that
``repr(type(x))`` — which the reference embeds inside hashed GeneralMatrix
reprs (algebra/matrices.py:40-41) — matches byte-for-byte.
"""
from __future__ import annotations

from typing import Union

import torch

from ..hashing.sampler import sample_short_poly_coeffs, sample_uniform_ntt_values
from ..ops import numtheory
from ..ops.ntt import make_plan, negacyclic_poly_mult, ntt_fwd, ntt_inv
from ..ops.upload import input_device, resolve_device
from . import serial


def _validate_ring(modulus, degree, root, inv_root, root_order):
    for name, v in (("modulus", modulus), ("degree", degree), ("root", root),
                    ("inv_root", inv_root), ("root_order", root_order)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"{name} must be an int")
    if (modulus - 1) % root_order != 0:
        raise ValueError("root_order must be a divisor of modulus - 1")
    if pow(root, root_order, modulus) != 1:
        raise ValueError("root must be a root of unity of order root_order")
    if not numtheory.is_primitive_root(root, modulus, root_order):
        raise ValueError("root must be a primitive root of unity of order root_order")
    if (root * inv_root) % modulus != 1:
        raise ValueError("root and inv_root must be inverses of each other")


def _as_values(vals, what: str, degree: int, device) -> torch.Tensor:
    """A list of ints (checked as the reference checks it) or an integer
    tensor -> int64 tensor[degree] on ``device`` (a tensor's own device when
    None, else the card)."""
    if isinstance(vals, torch.Tensor):
        if vals.dtype.is_floating_point or vals.dtype.is_complex or vals.dtype == torch.bool:
            raise TypeError(f"{what} must be a list of ints")
        if vals.dim() != 1 or vals.shape[0] != degree:
            raise ValueError(f"{what} must be of length degree")
        return vals.to(device=input_device(device, vals), dtype=torch.int64)
    if not isinstance(vals, list):
        raise TypeError(f"{what} must be a list")
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in vals):
        raise TypeError(f"{what} must be a list of ints")
    if len(vals) != degree:
        raise ValueError(f"{what} must be of length degree")
    return torch.tensor(vals, dtype=torch.int64, device=resolve_device(device))


class _PolyBase:
    """Shared ring metadata + centered reduction helpers."""

    __slots__ = ("modulus", "degree", "root", "inv_root", "root_order")

    def __init__(self, modulus: int, degree: int, root: int, inv_root: int, root_order: int):
        _validate_ring(modulus, degree, root, inv_root, root_order)
        self.modulus = modulus
        self.degree = degree
        self.root = root
        self.inv_root = inv_root
        self.root_order = root_order

    @property
    def halfmod(self) -> int:
        return self.modulus // 2

    @property
    def logmod(self) -> int:
        return self.modulus.bit_length() - 1

    def _same_ring(self, other) -> bool:
        return (
            self.modulus == other.modulus
            and self.degree == other.degree
            and self.root == other.root
            and self.root_order == other.root_order
        )

    def _require_same_ring(self, other, op: str):
        if self.modulus != other.modulus:
            raise NotImplementedError(f"Cannot {op} polynomials with different moduli")
        if self.degree != other.degree:
            raise NotImplementedError(f"Cannot {op} polynomials with different degrees")
        if self.root != other.root:
            raise NotImplementedError(f"Cannot {op} polynomials with different roots of unity")
        if self.root_order != other.root_order:
            raise NotImplementedError(f"Cannot {op} polynomials with different root orders")

    def _cent(self, t: torch.Tensor) -> torch.Tensor:
        """Centered representatives of int64 values (the reference's cent)."""
        r = t % self.modulus
        return torch.where(r > self.modulus // 2, r - self.modulus, r)

    def _plan(self):
        return make_plan(self.modulus, self.degree, self.root)

    def _ring(self) -> dict:
        return dict(modulus=self.modulus, degree=self.degree, root=self.root,
                    inv_root=self.inv_root, root_order=self.root_order)


class PolynomialCoefficientRepresentation(_PolyBase):
    """Coefficient-domain polynomial over Z_q[X]/(X^d + 1).

    Behavioral twin of reference algebra/polynomials.py:65-227; multiplication
    is NTT-based (exact: residues agree, centered canonical form is unique).
    """

    __slots__ = ("coefficients",)

    def __init__(self, modulus, degree, root, inv_root, root_order, coefficients, *,
                 device=None):
        super().__init__(modulus, degree, root, inv_root, root_order)
        self.coefficients = _as_values(coefficients, "coefficients", degree, device)

    @property
    def device(self) -> torch.device:
        return self.coefficients.device

    def __str__(self):
        return serial.poly_coef_str(
            self.modulus, self.degree, self.root, self.inv_root, self.root_order, self.coefficients
        )

    __repr__ = __str__

    def __eq__(self, other):
        if not isinstance(other, PolynomialCoefficientRepresentation):
            return False
        if not self._same_ring(other):
            return False
        q = self.modulus
        return torch.equal(self.coefficients % q, other.coefficients.to(self.device) % q)

    def __hash__(self):
        return hash((self.modulus, self.degree, tuple((self.coefficients % self.modulus).tolist())))

    def _with(self, coefficients: torch.Tensor) -> "PolynomialCoefficientRepresentation":
        return PolynomialCoefficientRepresentation(**self._ring(), coefficients=coefficients)

    def __add__(self, other):
        if other == 0:
            return self
        if not isinstance(other, PolynomialCoefficientRepresentation):
            raise NotImplementedError(
                f"Addition for {type(self)} and {type(other)} not implemented"
            )
        self._require_same_ring(other, "add")
        q = self.modulus
        return self._with(self._cent(self.coefficients % q + other.coefficients.to(self.device) % q))

    def __radd__(self, other):
        if other == 0:
            return self
        return self + other

    def __neg__(self):
        return self._with(-(self.coefficients % self.modulus))

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return other + (-self)

    def __mul__(self, other):
        if other == 0:
            return 0
        if other == 1:
            return self
        if not isinstance(other, PolynomialCoefficientRepresentation):
            raise NotImplementedError(
                f"Multiplication for {type(self)} and {type(other)} not implemented"
            )
        self._require_same_ring(other, "multiply")
        q = self.modulus
        return self._with(negacyclic_poly_mult(self._plan(), self.coefficients % q,
                                               other.coefficients.to(self.device) % q))

    def __rmul__(self, other):
        return self.__mul__(other)

    def norm(self, p: Union[int, str]) -> int:
        if p != "infty":
            raise NotImplementedError(f"norm for p={p} not implemented")
        return int(self.coefficients.abs().max())

    def weight(self) -> int:
        return int((self.coefficients % self.modulus != 0).sum())


class PolynomialNTTRepresentation(_PolyBase):
    """NTT-domain polynomial (bit-reversed evaluation order).

    Behavioral twin of reference algebra/polynomials.py:230-388."""

    __slots__ = ("values",)

    def __init__(self, modulus, degree, root, inv_root, root_order, values, *, device=None):
        super().__init__(modulus, degree, root, inv_root, root_order)
        self.values = _as_values(values, "values", degree, device)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __str__(self):
        return serial.poly_ntt_str(
            self.modulus, self.degree, self.root, self.inv_root, self.root_order, self.values
        )

    __repr__ = __str__

    def __eq__(self, other):
        if other == 0:
            return bool((self.values % self.modulus == 0).all())
        if not isinstance(other, PolynomialNTTRepresentation):
            return False
        if not self._same_ring(other) or self.inv_root != other.inv_root:
            return False
        q = self.modulus
        return torch.equal(self.values % q, other.values.to(self.device) % q)

    def __hash__(self):
        return hash((self.modulus, self.degree, tuple((self.values % self.modulus).tolist())))

    def _with(self, values: torch.Tensor) -> "PolynomialNTTRepresentation":
        return PolynomialNTTRepresentation(**self._ring(), values=values)

    def __add__(self, other):
        if other == 0:
            return self
        if not isinstance(other, PolynomialNTTRepresentation):
            raise NotImplementedError(
                f"Addition for {type(self)} and {type(other)} not implemented"
            )
        self._require_same_ring(other, "add")
        q = self.modulus
        return self._with(self._cent(self.values % q + other.values.to(self.device) % q))

    def __radd__(self, other):
        if other == 0:
            return self
        return self + other

    def __neg__(self):
        return self._with(-(self.values % self.modulus))

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return other + (-self)

    def __mul__(self, other):
        if other == 0:
            return 0
        if other == 1:
            return self
        if not isinstance(other, PolynomialNTTRepresentation):
            raise NotImplementedError(
                f"Multiplication for {type(self)} and {type(other)} not implemented"
            )
        self._require_same_ring(other, "multiply")
        q = self.modulus
        return self._with(self._cent((self.values % q) * (other.values.to(self.device) % q)))

    def __rmul__(self, other):
        return self.__mul__(other)


# Masquerade as the reference module so repr(type(...)) — embedded in hashed
# GeneralMatrix reprs — matches the wire format exactly.
PolynomialCoefficientRepresentation.__module__ = "algebra.polynomials"
PolynomialNTTRepresentation.__module__ = "algebra.polynomials"


def transform(x):
    """NTT <-> coefficient domain involution (reference
    algebra/polynomials.py:391-433) on the device of ``x``: kernel
    ``ntt_centered`` on a CUDA tensor."""
    if isinstance(x, PolynomialCoefficientRepresentation):
        vals = ntt_fwd(x._plan(), x._cent(x.coefficients).to(torch.int32))
        return PolynomialNTTRepresentation(**x._ring(), values=vals)
    if isinstance(x, PolynomialNTTRepresentation):
        coefs = ntt_inv(x._plan(), x._cent(x.values).to(torch.int32))
        return PolynomialCoefficientRepresentation(**x._ring(), coefficients=coefs)
    raise NotImplementedError(f"Transform for {type(x)} not implemented")


def sample_polynomial_coefficient_representation(
    modulus, degree, root, inv_root, root_order, norm_bound, weight_bound, seed, *, device=None
):
    """Object-returning seeded sampler (reference algebra/polynomials.py:436-467),
    on ``device`` (the card unless ``device="cpu"``)."""
    coefs = sample_short_poly_coeffs(modulus, degree, norm_bound, weight_bound, seed)
    return PolynomialCoefficientRepresentation(
        modulus=modulus, degree=degree, root=root, inv_root=inv_root, root_order=root_order,
        coefficients=torch.from_numpy(coefs), device=resolve_device(device),
    )


def sample_polynomial_ntt_representation(modulus, degree, root, inv_root, root_order, seed, *,
                                         device=None):
    """Object-returning uniform NTT sampler (reference algebra/polynomials.py:470-488),
    on ``device`` (the card unless ``device="cpu"``)."""
    vals = sample_uniform_ntt_values(modulus, degree, seed)
    return PolynomialNTTRepresentation(
        modulus=modulus, degree=degree, root=root, inv_root=inv_root, root_order=root_order,
        values=torch.from_numpy(vals), device=resolve_device(device),
    )


# ---------------------------------------------------------------------------
# GeneralMatrix
# ---------------------------------------------------------------------------


def is_algebraic_class(cls) -> bool:
    """Duck-type check for ring-element classes (reference algebra/matrices.py:5-7)."""
    return all(hasattr(cls, m) for m in ("__eq__", "__add__", "__neg__", "__sub__", "__mul__"))


class GeneralMatrix:
    """Element-type-generic matrix (behavioral twin of algebra/matrices.py:10-153).

    Kept list-of-lists and duck-typed for API parity; the scheme's hot paths do
    not use this class (they run on dense tensors) — it exists for users of the
    reference's algebra API and for serialization parity.
    """

    def __init__(self, matrix):
        if not isinstance(matrix, list):
            raise ValueError("Matrix must be a list")
        if not matrix:
            raise ValueError("Matrix must not be empty.")
        if any(not isinstance(row, list) for row in matrix):
            raise ValueError("Matrix must be a list of lists")
        if any(not row for row in matrix):
            raise ValueError("Matrix must not contain empty lists")
        if not all(len(row) == len(matrix[0]) for row in matrix):
            raise ValueError("All rows must have the same length")
        first_cls = matrix[0][0].__class__
        if not is_algebraic_class(first_cls):
            raise ValueError("Matrix must contain only instances of the same algebraic class")
        if not all(isinstance(item, first_cls) for row in matrix for item in row):
            raise ValueError("Matrix must contain only instances of the same algebraic class")
        self.elem_class = first_cls
        self.matrix = matrix

    # -- container protocol -------------------------------------------------
    def __len__(self):
        return len(self.matrix)

    def __iter__(self):
        return iter(self.matrix)

    def __getitem__(self, item):
        return self.matrix[item]

    def __setitem__(self, key, value):
        self.matrix[key] = value

    def __delitem__(self, key):
        # Quirk parity: the reference zeroes the row instead of deleting it
        # (algebra/matrices.py:58-59).
        self.matrix[key] = 0

    def __str__(self):
        return serial.matrix_str(
            repr(self.elem_class), ((str(item) for item in row) for row in self.matrix)
        )

    __repr__ = __str__

    # -- algebra ------------------------------------------------------------
    def __eq__(self, other):
        if other == 0:
            return all(item == 0 for row in self.matrix for item in row)
        if not isinstance(other, GeneralMatrix) or self.elem_class != other.elem_class:
            return False
        if len(self.matrix) != len(other.matrix) or len(self.matrix[0]) != len(other.matrix[0]):
            return False
        return self.matrix == other.matrix

    def _map(self, fn):
        return GeneralMatrix(matrix=[[fn(item) for item in row] for row in self.matrix])

    def _zip(self, other, fn):
        return GeneralMatrix(
            matrix=[
                [fn(a, b) for a, b in zip(ra, rb)] for ra, rb in zip(self.matrix, other.matrix)
            ]
        )

    def __add__(self, other):
        if other == 0:
            return self
        if not isinstance(other, GeneralMatrix) or self.elem_class != other.elem_class:
            raise NotImplementedError(
                "Can only add GeneralMatrix objects of the same algebraic class"
            )
        if len(self.matrix) != len(other.matrix) or len(self.matrix[0]) != len(other.matrix[0]):
            raise ValueError("Matrix dimensions must match")
        return self._zip(other, lambda a, b: a + b)

    def __radd__(self, other):
        if other == 0:
            return self
        return self + other

    def __neg__(self):
        return self._map(lambda a: -a)

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if isinstance(other, self.elem_class):
            return self._map(lambda a: a * other)
        if not isinstance(other, GeneralMatrix) or self.elem_class != other.elem_class:
            raise TypeError("Can only multiply matrices of the same algebraic class")
        if len(self.matrix[0]) != len(other.matrix):
            raise ValueError("Matrix dimension mismatch")
        rows, inner, cols = len(self.matrix), len(other.matrix), len(other.matrix[0])
        out = [
            [
                sum((self.matrix[i][k] * other.matrix[k][j] for k in range(1, inner)),
                    start=self.matrix[i][0] * other.matrix[0][j])
                for j in range(cols)
            ]
            for i in range(rows)
        ]
        return GeneralMatrix(matrix=out)

    def __mod__(self, other):
        if not isinstance(other, int):
            raise TypeError("Can only take the remainder of a matrix with an integer")
        if other <= 1:
            raise ValueError("Modulus must be greater than 1")
        return self._map(lambda a: a % other)

    def norm(self, p: Union[int, str]):
        if not all(hasattr(item, "norm") for row in self.matrix for item in row):
            raise NotImplementedError("Matrix elements must have a norm method")
        if p == "infty":
            return max(item.norm(p=p) for row in self.matrix for item in row)
        return None

    def weight(self):
        if not all(hasattr(item, "weight") for row in self.matrix for item in row):
            raise NotImplementedError("Matrix elements must have a weight method")
        return max(item.weight() for row in self.matrix for item in row)


GeneralMatrix.__module__ = "algebra.matrices"
