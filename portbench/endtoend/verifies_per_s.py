"""Groups verified in the window over the window's seconds; every call ends
with its verdicts on the host."""


def read(window):
    return window.answers / window.seconds
