"""kernels/candidates.py (csrc/candidates.cu): the least time the bytes a
launch needs take at the card's HBM peak, over the profiled device time a
launch in the traced part of the window, in percent.  The bytes are
those the shapes give (harness/roofline.py), an upper count, so the share
is an upper reading; the time a launch is that of the launches the
profiler recorded (`run.candidates_sample` in the result line says
where in a request they lie)."""

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel("candidates_kernel")
    nb = roofline.candidates_bytes(run.dims, run.cell.config["search"])
    return roofline.share(nb, seconds, launches)
