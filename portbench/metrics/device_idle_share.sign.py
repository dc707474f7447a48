"""Share of the traced segment in which no operation ran on the card, in %
(``tracing.Trace.idle_share``); a multi-card run gives its largest rank's."""


def read(trace):
    return trace.idle_share() if trace.on_device else None
