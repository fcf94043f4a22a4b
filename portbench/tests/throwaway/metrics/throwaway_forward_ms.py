"""The synchronized forward span, median over the forwards."""
from portbench import readers


def read(r):
    return readers.span_median(r, "forward")
