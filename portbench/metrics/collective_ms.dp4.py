"""Device ms a call in NCCL kernels (the verdicts' all-gather), the largest
over the ranks."""
from portbench.tracing import is_collective


def read(trace):
    if not trace.on_device:
        return None
    return trace.device_ms(is_collective) / trace.calls
