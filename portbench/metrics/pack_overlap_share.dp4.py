"""Share of the host time inside the program's spans ``fct.pack``
(``device_pipeline._message_tensors``: packing a chunk's messages) during
which the card was busy, in %: 100 x (the spans' time that overlaps the
union of device activity) / (the spans' time).  Near 0 where every chunk's
packing waits for an idle card, near 100 where chunk k+1's packing hides
under chunk k's device work.  A multi-card run gives its largest rank's;
None where the program opens no such span."""
from bisect import bisect_right

from portbench.program_spans import spans


def read(trace):
    packs = spans(trace, "fct.pack")
    if not trace.on_device or not packs:
        return None
    busy = trace.busy  # sorted, disjoint
    starts = [a for a, _ in busy]
    total = overlap = 0.0
    for a, b in packs:
        total += b - a
        k = max(0, bisect_right(starts, a) - 1)
        while k < len(busy) and busy[k][0] < b:
            overlap += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
    return 100.0 * overlap / total if total > 0 else None
