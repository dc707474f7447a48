"""Interoperability layer: reference-exact serialization, the on-device
preimage templates, the object API mirroring the reference's public classes,
and the KAT corpus harness."""
