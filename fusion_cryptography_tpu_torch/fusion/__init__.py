"""Drop-in import surface mirroring the reference's ``fusion`` package:
``from fusion_cryptography_tpu_torch.fusion.fusion import fusion_setup, keygen, ...``"""
from . import fusion
