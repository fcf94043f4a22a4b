"""The whole conversion's least time at the card's peaks over the time it took."""
from portbench import readers


def read(r):
    return readers.mfu(r)
