"""Device ms a call of the operations launched inside the program's span
``fct.sign.product`` (``lifecycle.sign``: sig = sk_l * c + sk_r in int64
torch glue), with no sync."""
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.sign.product"):
        return None
    return trace.device_ms_in("fct.sign.product") / trace.calls
