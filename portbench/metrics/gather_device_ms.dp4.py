"""Device ms a call of the operations launched inside the program's span
``fct.shard.gather`` (``parallel/sharded.sharded_verify_local``: the
verdicts' uint8 stack, the NCCL all-gather, which waits there for the
slowest rank, and the unpack to bool); a multi-card run gives its largest
rank's.  None where the program opens no such span."""
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.shard.gather"):
        return None
    return trace.device_ms_in("fct.shard.gather") / trace.calls
