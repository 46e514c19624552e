"""From the process's start to the window's: imports, the CUDA context,
the kernels' build (compiled only by a checkout's first run), the inputs
made from the seed, the system built and the warm-up requests that
capture its graphs."""


def read(run):
    return run.setup_s
