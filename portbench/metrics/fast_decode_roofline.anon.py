"""fast_decode_roofline.anon: the kernel's least time from the configuration's counts over its device time."""
from portbench import readers


def read(r):
    return readers.roofline(r, "fast_decode")
