"""Host ms a call inside the program's span ``fct.sign`` (``lifecycle.sign``:
message packing, the prehash and signer stages, the signature product)."""
from portbench.program_spans import host_ms


def read(trace):
    return host_ms(trace, "fct.sign")
