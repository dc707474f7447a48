"""Device ms a call of the operations launched inside the program's span
``fct.group.fold``: kernel ``agg_fold`` (with its prefix launch at wide
groups).  None where the program opens no such span."""
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.group.fold"):
        return None
    return trace.device_ms_in("fct.group.fold") / trace.calls
