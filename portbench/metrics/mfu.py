"""The whole step's share of the card's f32 peak: the configuration's
fixed work per step (its reference's ``model_flops``, the same whatever
the port runs to compute it) times the measured window's steps, over
their seconds (no profiler) and ``work.PEAK_F32_FLOPS``."""
from portbench import work


def read(record):
    seconds = sum(o.seconds for o in record.window.outputs)
    if seconds <= 0:
        return None
    flops = record.model_flops * len(record.window.outputs)
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS
