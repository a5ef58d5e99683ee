"""Readings that set the check's limits: the program's, over many seeds,
and the control's, which has to fail.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out control.jsonl]

For every seed: set up the cell as a run does, run one step of the
program (build and evaluate, the window's entry) and judge it.  For a
control seed, also the control, judged the same way: each layer one
precision below what the configuration states (f32 with TF32 off):

* the factorization: the program's build with TF32 matrix products on
  (``torch.backends.cuda.matmul.allow_tf32``), the temptation of its
  GEMM-bound loops;
* scoring: the plain route in the kernel's place, scores from those
  factors with TF32 operands (10-bit mantissas, rounded to nearest) and
  f32 sums, masked and ranked by ``torch.topk``;
* evaluation: the plain metrics in f32 in place of the port's f64.

Not part of a benchmark run.  Prints one JSON line per seed and role.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import judge, plain, spec, synthetic


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


def control_picks(ref, factors, problem, k, device) -> np.ndarray:
    """The plain scoring route with TF32 operands and f32 sums."""
    items = tf32(ref.item_panel(factors, device, torch.float32))
    out = []
    for lo, hi in plain.user_blocks(len(problem.test_users)):
        proj = tf32(ref.user_panel(factors, problem, np.arange(lo, hi),
                                   device, torch.float32))
        scores = proj @ items.T
        seen = plain.dense_rows(problem, problem.test_users[lo:hi], device,
                                torch.float32) != 0
        scores = scores.masked_fill(seen, -torch.inf)
        out.append(torch.topk(scores, k, dim=1).indices.cpu().numpy())
    return np.concatenate(out)


def readings(workload: str, seeds, control_seeds, device, geometry=None,
             emit=print):
    cell = spec.resolve(spec.load(), workload)
    cfg, traffic = cell.config, cell.traffic
    sizes = dict(cfg["data"], **(geometry or {}))
    ref = spec.reference(cell.entry["config"])
    kind = spec.kind(traffic)
    off = lambda name: contextlib.nullcontext()
    collectors = {"power_iters": spec.metric_reader("power_iters").collect}
    from portbench.system import PortSystem
    for seed in seeds:
        start = time.perf_counter()
        events = synthetic.make_events(sizes["n_users"], sizes["n_items"],
                                       sizes["n_events"], seed, device)
        hold = synthetic.holdout_mask(events.rows, seed)
        system = PortSystem(cfg, traffic, [device],
                            synthetic.torch_seed(seed))
        system.prepare(events.rows, events.cols, events.vals, hold)
        setup_s = time.perf_counter() - start
        start = time.perf_counter()
        program = kind.step(system, off, collectors)
        step_s = time.perf_counter() - start
        control = None
        if seed in control_seeds:
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = kind.step(system, off, {})
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        system.release()
        del system
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        problem = plain.make_problem(events.rows, events.cols, events.vals,
                                     hold)
        start = time.perf_counter()
        state = ref.prepare(problem, cfg, synthetic.torch_seed(seed), device)
        prepare_s = time.perf_counter() - start
        k = traffic["topk"]
        values = judge.step_checks(ref, state, problem, program.factors,
                                   program.recs, program.metrics, k, device)
        emit(json.dumps({"workload": workload, "seed": seed,
                         "role": "program", "readings": values,
                         "setup_s": setup_s, "step_s": step_s,
                         "reference_s": prepare_s,
                         "power_iters": program.counters["power_iters"]}))
        if control is not None:
            recs = control_picks(ref, control.factors, problem, k, device)
            metrics = plain.metrics(problem, recs, dtype=np.float32)
            values = judge.step_checks(ref, state, problem, control.factors,
                                       recs, metrics, k, device)
            emit(json.dumps({"workload": workload, "seed": seed,
                             "role": "control", "readings": values}))
        del state
        gc.collect()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    try:
        readings(args.workload, seeds + sorted(control_seeds - set(seeds)),
                 control_seeds, torch.device("cuda:0"), emit=emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
