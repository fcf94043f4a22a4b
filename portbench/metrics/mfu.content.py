"""The step's counted work (the teacher at the float16 peak, the student at float32's, AdamW at the memory rate) over the unsynchronized steps' time."""
from portbench import readers


def read(r):
    return readers.mfu(r)
