"""Percent of the traced window in which no kernel, copy or set ran on
the card."""


def read(record):
    if record.trace is None or record.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)
