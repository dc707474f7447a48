"""Kernel launches a call (CUDA runtime or driver calls whose name holds
``LaunchKernel``) issued inside the program's span ``fct.verify``, the
whole grouped verify call."""
from portbench.program_spans import runtime_calls


def read(trace):
    if not trace.on_device:
        return None
    return runtime_calls(trace, "LaunchKernel", ("fct.verify",))
