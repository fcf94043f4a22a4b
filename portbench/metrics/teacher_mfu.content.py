"""The w2v-BERT teacher's share of its roofline: the least time of its
counted operations at the traced stretch's rows and valid frames, at the
float16 peak, over the device ms of the port's `teacher` spans."""
from portbench import program_spans


def read(r):
    least, ms = r.get("teacher_least_s"), program_spans.device_ms(r, "teacher")
    return 100.0 * least / (sum(ms) / 1e3) if least and ms and sum(ms) > 0 else None
