"""Scheme layer: the batched tensor lifecycle, grouped verify and fleet build."""
from .lifecycle import (
    KeyBatch,
    SignatureBatch,
    aggregate,
    keygen,
    sign,
    verify,
    verify_batch,
    verify_many,
)
