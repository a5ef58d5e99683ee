"""On the card: the program passes the check and the control fails it.

Run on a machine with the card:

    python3 -m pytest portbench/tests -m cuda -p no:cacheprovider

At a quarter of the cells' users (the catalog and the settings as
configured), so that a test run holds it.
"""
import json

import pytest
import torch

from portbench import control, judge, spec

QUARTER = dict(n_users=17_470, n_items=10_677, n_events=2_500_000)
WORKLOADS = [w["name"] for w in spec.load()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernel and TF32 run "
                    "only there")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(card, workload):
    lines = []
    seed = 2 ** 31 + 4242
    control.readings(workload, [seed], {seed}, card, geometry=QUARTER,
                     emit=lines.append)
    program, lower = (json.loads(line) for line in lines)
    limits = spec.resolve(spec.load(), workload).config["limits"]
    assert program["role"] == "program" and lower["role"] == "control"
    assert all(judge.passes(program["readings"][n], limit)
               for n, limit in limits.items()), program
    failed = [n for n, limit in limits.items()
              if not judge.passes(lower["readings"][n], limit)]
    assert failed, lower
