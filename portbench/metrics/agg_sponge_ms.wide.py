"""Device ms a call of the operations launched inside the program's span
``fct.group.sponge``: the aggregation preimage's SHAKE256 padding, absorb
and squeeze (``device_pipeline.make_stages``' group stage).  None where
the program opens no such span."""
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.group.sponge"):
        return None
    return trace.device_ms_in("fct.group.sponge") / trace.calls
