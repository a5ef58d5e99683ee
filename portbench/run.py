"""Run one cell of the port's benchmark on the card this machine holds.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the numbers compared by the check as the last lines of standard
error, and one JSON result line as the last line of standard output.
Exits non-zero without a result when CUDA is missing, when the machine
has fewer cards than the cell asks for, or when the process has loaded
JAX or the JAX package; and non-zero after the result when the run is not
correct.
"""
from __future__ import annotations

import time

CLOCK_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from portbench import harness, spec

    chips = spec.resolve(spec.load(), args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              clock_start=CLOCK_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    for name, (value, limit) in result.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line))
    return 0 if result.line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
