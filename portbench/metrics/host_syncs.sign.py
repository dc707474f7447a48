"""Calls a call that make the host wait for the card (CUDA runtime or
driver calls whose name holds ``Synchronize``) issued inside the program's
spans ``fct.keygen`` or ``fct.sign``."""
from portbench.program_spans import runtime_calls


def read(trace):
    if not trace.on_device:
        return None
    return runtime_calls(trace, "Synchronize", ("fct.keygen", "fct.sign"))
