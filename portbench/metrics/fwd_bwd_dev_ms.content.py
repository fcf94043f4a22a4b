"""The median device ms of the port's `fwd_bwd` span over the traced steps."""
from portbench import program_spans


def read(r):
    return program_spans.median_device_ms(r, "fwd_bwd")
