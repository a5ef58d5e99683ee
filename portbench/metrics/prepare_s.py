"""Seconds of the port's data tier in set-up: the data model over the
events (``RecommenderData``, ``prepare_training_only``, ``set_test_data``),
by the benchmark's synchronized host clock."""


def read(record):
    return record.setup_spans.get("prepare")
