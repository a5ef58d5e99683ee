"""Milliseconds of one ``evaluate()`` (picks for every test user through
the fused kernel, then the metric families), by the benchmark's
synchronized host clock, averaged over the measured window's steps (not
the profiled ones)."""


def read(record):
    values = [o.spans["evaluate"] for o in record.window.outputs]
    return 1e3 * sum(values) / len(values) if values else None
