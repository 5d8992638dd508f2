"""Seconds from the process's start to the window's: CUDA set-up, the
kernels' build (first run in a checkout) or load, the matrix and its
values, ``prepare`` and the warm-up."""


def read(run):
    return run.setup_s
