"""Drop-in import surface for the reference's ``algebra.polynomials``."""
from ..interop.objects import (
    PolynomialCoefficientRepresentation,
    PolynomialNTTRepresentation,
    sample_polynomial_coefficient_representation,
    sample_polynomial_ntt_representation,
    transform,
)

__all__ = [
    "PolynomialCoefficientRepresentation",
    "PolynomialNTTRepresentation",
    "transform",
    "sample_polynomial_coefficient_representation",
    "sample_polynomial_ntt_representation",
]
