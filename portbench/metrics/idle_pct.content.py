"""The card's idle share of the profiled sub-window."""
from portbench import readers


def read(r):
    return readers.idle(r)
