"""Seconds from the start of the run's command to the window's first call:
importing torch, building or loading the kernels, the parameters, the
inputs from the seed and the warm-up calls."""


def read(window):
    return window.setup_s
