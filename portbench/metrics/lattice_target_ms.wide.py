"""Device ms a call of the operations launched inside the program's span
``fct.lattice.target``: kernel ``lattice_target`` (its partial sums and
their combination where the signers are split).  None where the program
opens no such span."""
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.lattice.target"):
        return None
    return trace.device_ms_in("fct.lattice.target") / trace.calls
