"""The synchronized fwd_bwd span of a training step, median over the steps."""
from portbench import readers


def read(r):
    return readers.span_median(r, "fwd_bwd")
