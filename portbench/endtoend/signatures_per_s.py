"""Keys generated and signed in the window over the window's seconds; every
call ends with its sampled keys' vks and signatures on the host."""


def read(window):
    return window.answers / window.seconds
