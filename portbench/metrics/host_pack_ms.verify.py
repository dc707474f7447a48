"""Host ms a call inside the port's message packing
(``scheme/device_pipeline._message_tensors``), which the benchmark's range
wraps."""


def read(trace):
    return trace.range_ms("host.pack") / trace.calls
