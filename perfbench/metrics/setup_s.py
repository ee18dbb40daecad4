"""Seconds from the start of the run's process to the window's start:
imports, inputs, weights, warm-up and any kernel build (host clock)."""


def read(run):
    return run.setup_s
