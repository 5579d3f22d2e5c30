"""Seconds from the start of the run's script to the start of the window:
importing torch, reaching the card, building or loading the kernels, making
the inputs, setting the program up and the warm-up calls."""


def read(run):
    return run.setup_s
