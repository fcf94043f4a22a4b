"""The step's operations (forward and backward of the LM, the features' forward; no recompute) at 67 TFLOP/s float32 over the step's time."""
from portbench import readers


def read(r):
    return readers.mfu(r)
