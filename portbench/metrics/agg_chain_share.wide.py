"""The aggregation sponge's chain against one SM, in %: each traced call's
longest group's aggregation sponge (``chain_perms`` of the driver's work
count, ``drivers/verify_wide.py``), one permutation after another, takes
at least its permutations x ``roofline.KECCAK_OPS`` INT32 instructions at
one SM's rate (64 a clock at 1.98 GHz); summed over the calls, over the
device ms launched inside ``fct.group.sponge`` (``agg_sponge_ms.wide``).
None where the program opens no such span."""
from portbench import roofline
from portbench.program_spans import spans

SM_INT_OPS_PER_S = 64 * 1.98e9


def read(trace):
    if not trace.on_device or not spans(trace, "fct.group.sponge"):
        return None
    sponge_s = trace.device_ms_in("fct.group.sponge") / 1e3
    if sponge_s <= 0:
        return None
    least = sum(w["chain_perms"] * roofline.KECCAK_OPS for w in trace.work()) / SM_INT_OPS_PER_S
    return 100.0 * least / sponge_s
