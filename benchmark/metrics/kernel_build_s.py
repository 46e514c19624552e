"""Kernel build (cruise_control_tpu_torch/kernels/_build.py): the seconds
set-up spends in the build of the port's CUDA libraries, in s.  A
checkout's first run compiles them with nvcc; every later run finds them
built and reads only the check that they are current.  Part of setup_s."""


def read(run):
    return run.build_s
