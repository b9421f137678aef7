"""setup_s: the process's start to the window's opening, wall clock:
CUDA's start, the kernels' libraries, the weights, the engines, the
warm-up prefills and the ramp."""


def read(run, variant):
    return run.setup_s
