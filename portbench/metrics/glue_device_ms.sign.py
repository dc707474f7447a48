"""Device ms a call in kernels that are not the port's own (PyTorch's
elementwise and reduction kernels: the lifecycle's int64 glue), classified
by ``tracing.port_kernel``."""
from portbench.tracing import is_collective, port_kernel


def read(trace):
    if not trace.on_device:
        return None
    glue = trace.device_ms(lambda n: port_kernel(n) is None and not is_collective(n),
                           cats=("kernel",))
    return glue / trace.calls
