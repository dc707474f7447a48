"""Kernel ``lattice_target`` against the card's memory rate, in %: each
traced call's least bytes of the target half (``target_bytes`` of the
driver's work count, ``drivers/verify_wide.py``) at 3.35 TB/s, summed over
the calls, over the device ms launched inside ``fct.lattice.target``
(``lattice_target_ms.wide``).  None where the program opens no such span."""
from portbench import roofline
from portbench.program_spans import spans


def read(trace):
    if not trace.on_device or not spans(trace, "fct.lattice.target"):
        return None
    target_s = trace.device_ms_in("fct.lattice.target") / 1e3
    if target_s <= 0:
        return None
    least = sum(w["target_bytes"] for w in trace.work()) / roofline.HBM_BYTES_PER_S
    return 100.0 * least / target_s
