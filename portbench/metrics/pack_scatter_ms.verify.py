"""Host ms a call inside the program's span ``fct.pack.scatter``
(``device_pipeline.msg_preimage_words``: the zero-filled word buffer, the
length mask and the masked byte assignment)."""
from portbench.program_spans import host_ms


def read(trace):
    return host_ms(trace, "fct.pack.scatter")
