"""The traced calls' least device time over the device's busy time in them,
in %: the least time of each call's work (``roofline.verify_work``, from
the scheme's sizes and the call's inputs) summed over the calls, against
the union of device activity in the segment."""
from portbench import roofline


def read(trace):
    if not trace.on_device:
        return None
    least = sum(roofline.least_seconds(w) for w in trace.work())
    return 100.0 * least / trace.busy_s
