"""Host ms a call inside the program's span ``fct.pack.upload``
(``device_pipeline._message_tensors``: the packed words and lengths copied
into pinned memory and sent to the card without waiting)."""
from portbench.program_spans import host_ms


def read(trace):
    return host_ms(trace, "fct.pack.upload")
