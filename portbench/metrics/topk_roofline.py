"""The fused score -> mask -> top-k kernel's share of its roofline: the
least time its calls could take on the card (``work.topk_least_seconds``
for every tested user, once per profiled step) over the traced device
time of the kernel's entry point (its panel transpose, score and
split-merge kernels).  Nothing to read without a device trace of the kernel."""
import re

from portbench import work

KERNELS = re.compile(r"score_topk|transpose_panel_kernel|merge_splits_kernel")


def read(record):
    if record.trace is None or not record.traced.outputs:
        return None
    seconds = record.trace.seconds_matching(KERNELS)
    if seconds <= 0:
        return None
    problem = record.problem
    rank = record.cell.config["model"]["attributes"]["rank"]
    least = work.topk_least_seconds(len(problem.test_users), problem.n_items,
                                    rank, record.cell.traffic["topk"])
    return 100.0 * least * len(record.traced.outputs) / seconds
