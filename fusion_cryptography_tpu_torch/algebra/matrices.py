"""Drop-in import surface for the reference's ``algebra.matrices``."""
from ..interop.objects import GeneralMatrix, is_algebraic_class

__all__ = ["GeneralMatrix", "is_algebraic_class"]
