"""Drop-in import surface mirroring the reference's ``algebra`` package
(the port of the JAX package's ``algebra``):

    from fusion_cryptography_tpu_torch.algebra.ntt import cooley_tukey_ntt
    from fusion_cryptography_tpu_torch.algebra.polynomials import ...
    from fusion_cryptography_tpu_torch.algebra.matrices import GeneralMatrix
"""
from . import matrices, ntt, polynomials
