"""Amazon reviews loader (host copy of :mod:`polara_tpu.datasets.amazon`;
reference ``polara/datasets/amazon.py:12-25``).  pandas loads on the first
call."""
from __future__ import annotations

import gzip
from ast import literal_eval


def parse_meta(path):
    """Iterate python-literal records from a gzipped metadata dump."""
    with gzip.open(path, "rt") as gz:
        for line in gz:
            yield literal_eval(line)


def get_amazon_data(path=None, meta_path=None, nrows=None):
    """Load the ratings-only CSV (userid/asin/rating) and/or the
    product-metadata dump."""
    import pandas as pd

    res = []
    if path:
        data = pd.read_csv(path, header=None,
                           names=["userid", "asin", "rating", "timestamp"],
                           usecols=["userid", "asin", "rating"],
                           nrows=nrows)
        res.append(data)
    if meta_path:
        records = parse_meta(meta_path)
        if nrows is not None:
            from itertools import islice
            records = islice(records, nrows)
        res.append(pd.DataFrame.from_records(list(records)))
    return res[0] if len(res) == 1 else res
