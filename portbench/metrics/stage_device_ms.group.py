"""Device ms a call of the operations launched inside the benchmark's range
around the pipeline's ``group`` stage (``_Pipeline.group``), with no sync."""


def read(trace):
    if not trace.on_device:
        return None
    return trace.device_ms_in("stage.group") / trace.calls
