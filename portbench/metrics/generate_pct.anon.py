"""The synchronized generate spans' share of their part of the window."""
from portbench import readers


def read(r):
    return readers.span_share(r, "generate")
