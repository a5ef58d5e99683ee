"""Seconds of one build, by the model's own ``training_time`` (the port's
``track_time`` synchronizes every card), averaged over the measured
window's builds (not the profiled ones)."""


def collect(model):
    return model.training_time[-1]


def read(record):
    values = [o.counters["build_s"] for o in record.window.outputs]
    return sum(values) / len(values) if values else None
