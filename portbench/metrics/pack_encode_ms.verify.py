"""Host ms a call inside the program's span ``fct.pack.encode``
(``device_pipeline.msg_preimage_words``: each message's ``dst + ","``
prefix and UTF-8 encoding, their lengths, the join)."""
from portbench.program_spans import host_ms


def read(trace):
    return host_ms(trace, "fct.pack.encode")
