"""The synchronized features span of a training step, median over the steps."""
from portbench import readers


def read(r):
    return readers.span_median(r, "features")
