"""Host ms a call inside the port's key sampler
(``scheme/device_setup._sample_sk``, called by ``lifecycle.keygen``), which
the benchmark's range wraps."""


def read(trace):
    return trace.range_ms("host.sampler") / trace.calls
