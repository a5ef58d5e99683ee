"""Time the two single-device iALS tiers of the port against each other.

    python3 ials_tiers.py [--device cuda] [--out FILE]

For each geometry (ML-10M's, then uniform blocks from 1% to 60% dense)
it builds iALS at rank 50 for 15 epochs on the dense tier
(``ials_train``) and on the event tier (``ials_train_events``) from the
same seed, each after a warm-up build, and prints one JSON line: the
seconds of each build (host clock around synchronized work), the event
tier's staging alone (a build of 0 epochs) and seconds per epoch as
``chip_smoke.py`` phase 7 reports them, the work estimates of
``ials_tier_work``, the ratio of the tiers' seconds per unit of that
work (``EVENT_TIER_COST`` is its value where the two tiers take equal
time, between the 40% and 60% blocks), the tier the rule picks
and the faster one, whether two event-tier builds gave the same bits,
and the tiers' factor gap.  The last line holds the card's name and
power limit and the median ratio.  ``--device cpu --small`` rehearses it
at tiny sizes.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from polara_tpu_torch.ops import implicit as imp

RANK, EPOCHS = 50, 15
IALS = dict(alpha=1.0, weight="log2", epsilon=1.0, reg=0.01)
# (name, n_users, n_items, density); "ml10m" draws the calibrated
# generator's 10,000,054 events, the others uniform cells
GEOMETRIES = [("ml10m", 69878, 10677, None),
              ("u1", 6000, 2000, 0.01),
              ("u10", 20000, 8000, 0.10),
              ("u20", 8000, 4000, 0.20),
              ("u40", 8000, 4000, 0.40),
              ("u60", 8000, 4000, 0.60)]
SMALL = [("ml10m", 600, 400, None), ("u1", 600, 400, 0.01),
         ("u40", 200, 100, 0.40)]


def events_of(name, n_users, n_items, density, device, seed=0):
    """Row-sorted (rows, cols, ratings 1..5) on ``device``."""
    if density is None:
        from polara_tpu_torch.datasets import make_realistic_coo_device
        n_events = 10_000_054 if n_users == 69878 else n_users * n_items // 75
        rows, cols, vals = make_realistic_coo_device(
            n_users, n_items, n_events, seed=seed, device=device)
        return rows, cols, vals.float()
    gen = torch.Generator(device=device).manual_seed(seed)
    cells = torch.rand((n_users, n_items), generator=gen, device=device)
    rows, cols = torch.nonzero(cells < density, as_tuple=True)
    vals = torch.randint(1, 6, rows.shape, generator=gen,
                         device=device).float()
    return rows, cols, vals


def timed(fn, device):
    """``fn()``'s result and its seconds, synchronized on ``device``."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    sync()
    start = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - start


def gap(a, b) -> float:
    return max(float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
               for x, y in zip(a, b))


def measure(geometry, device, warm: bool) -> dict:
    name, n_users, n_items, density = geometry
    rows, cols, vals = events_of(*geometry, device)
    shape = (n_users, n_items)
    dense = torch.zeros(shape, dtype=torch.float32, device=device)
    dense[rows, cols] = vals

    def dense_build(epochs=EPOCHS):
        return imp.ials_train(dense, RANK, num_epochs=epochs, seed=0,
                              **IALS)

    def events_build(epochs=EPOCHS):
        return imp.ials_train_events(rows, cols, vals, shape, RANK,
                                     num_epochs=epochs, seed=0, **IALS)

    if warm:
        dense_build(1)
        events_build(1)
    full, dense_s = timed(dense_build, device)
    _, staging_s = timed(lambda: events_build(0), device)
    first, events_s = timed(events_build, device)
    second, _ = timed(events_build, device)
    nnz = len(vals)
    work = imp.ials_tier_work(n_users, n_items, nnz, RANK, EPOCHS)
    raw_events = work["events"] / imp.EVENT_TIER_COST
    ratio = (events_s / raw_events) / (dense_s / work["dense"])
    return {"geometry": name, "n_users": n_users, "n_items": n_items,
            "nnz": nnz, "density": nnz / (n_users * n_items), "rank": RANK,
            "epochs": EPOCHS, "dense_s": dense_s, "events_s": events_s,
            "events_staging_s": staging_s,
            "epoch_s": {"dense": dense_s / EPOCHS,
                        "events": (events_s - staging_s) / EPOCHS},
            "dense_work": work["dense"], "events_work": work["events"],
            "cost_ratio": ratio,
            "rule_tier": ("events" if work["events"] < work["dense"]
                          else "dense"),
            "faster_tier": "events" if events_s < dense_s else "dense",
            "events_repeat_equal": all(torch.equal(a, b)
                                       for a, b in zip(first, second)),
            "tier_gap": gap(first, full)}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    lines = []
    for i, geometry in enumerate(SMALL if args.small else GEOMETRIES):
        lines.append(measure(geometry, args.device, warm=i == 0))
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"device": (torch.cuda.get_device_name(0)
                             if args.device == "cuda" else args.device),
                  "card": card() if args.device == "cuda" else None,
                  "cost_ratio_median": statistics.median(
                      line["cost_ratio"] for line in lines)})
    print(json.dumps(lines[-1]))
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
