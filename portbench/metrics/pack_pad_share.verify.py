"""Share of the packed message bytes sent to the card that are padding, in
%: 100 x (shipped - payload) / shipped, from the program's counters
``pack.shipped_bytes`` (B x Wt x 4 a chunk) and ``pack.payload_bytes`` (the
preimages' bytes), which count while the segment is traced.  Read in the
traced process itself."""


def read(trace):
    try:
        from fusion_cryptography_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    shipped = c.get("pack.shipped_bytes", 0)
    if not shipped:
        return None
    return 100.0 * (shipped - c.get("pack.payload_bytes", 0)) / shipped
