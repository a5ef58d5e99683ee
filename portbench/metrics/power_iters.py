"""Power iterations of one build, as the subspace solver counts them
(``svd_info["iterations"]``, summed over its block widths), averaged over
the measured window's builds.  Nothing to read for models without that
solver."""


def collect(model):
    iterations = (getattr(model, "svd_info", None) or {}).get("iterations")
    return sum(count for _, count in iterations) if iterations else None


def read(record):
    counts = [o.counters["power_iters"] for o in record.window.outputs
              if o.counters["power_iters"] is not None]
    return sum(counts) / len(counts) if counts else None
