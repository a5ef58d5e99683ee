"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up makes the cell's events and holdout from the seed on the device,
prepares the port's data model and warms the shapes the window uses (the
traffic's kind says how).  The kind's window then runs for ``seconds``
and gives its end-to-end values.  A traced run adds, after that window,
the shortest one (``seconds`` 0: one unit of work) under the profiler,
so that the host-clock per-layer metrics come from unprofiled work.
Once the windows have closed, the peak memory is read, the port's state
is freed, and the plain reference judges every output of both windows.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from typing import NamedTuple, Optional

import torch

from portbench import judge, plain, spec, synthetic, trace

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "polara_tpu")


class Window(NamedTuple):
    """What a kind's window gives back."""
    outputs: list                # each unit's outputs, judged after
    values: dict                 # end-to-end values besides setup_s
    error: Optional[str]         # the traceback that ended it, if any


class RunRecord(NamedTuple):
    """What the per-layer metric readers read."""
    cell: spec.Cell
    problem: plain.Problem
    setup_spans: dict            # seconds of each set-up part
    window: Window               # the measured window (no profiler)
    traced: Optional[Window]     # the profiled window of a traced run
    trace: Optional[trace.TraceSummary]   # the profiled window's trace
    model_flops: float           # the configuration's fixed work per step


class Result(NamedTuple):
    line: dict                   # the result line
    checks: dict                 # {name: (value, limit)}


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    loaded = {name.split(".")[0] for name in sys.modules}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def _record():
    """``record(name)``: a context that marks a benchmark span in the
    trace."""
    from torch.profiler import record_function
    return lambda name: record_function(trace.PREFIX + name)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", clock_start: Optional[float] = None,
             geometry: Optional[dict] = None, log=sys.stderr) -> Result:
    """Run the cell and judge it.  ``device`` is ``"cuda"`` (the cell's
    ``chips`` cards from the first) or ``"cpu"``; ``clock_start``
    (``perf_counter``) is when set-up began; ``geometry`` replaces the
    configuration's data sizes (the CPU tests' small runs)."""
    from portbench.system import PortSystem, sync

    clock_start = time.perf_counter() if clock_start is None else clock_start
    cell = spec.resolve(spec.load(), workload)
    cfg, traffic = cell.config, cell.traffic
    devices = [torch.device(device, i) if device == "cuda"
               else torch.device(device) for i in range(cell.entry["chips"])]
    device = devices[0]
    kind = spec.kind(traffic)
    collectors = {}
    for metric in cell.per_layer:
        reader = spec.metric_reader(metric["name"])
        if hasattr(reader, "collect"):
            collectors[metric["name"]] = reader.collect
    sizes = dict(cfg["data"], **(geometry or {}))
    spans = {"start": time.perf_counter() - clock_start}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        sync(device)
        spans[name] = time.perf_counter() - start
        return out

    events = timed("data", synthetic.make_events, sizes["n_users"],
                   sizes["n_items"], sizes["n_events"], seed, device)
    hold = timed("holdout", synthetic.holdout_mask, events.rows, seed)
    system = timed("import", PortSystem, cfg, traffic, devices,
                   synthetic.torch_seed(seed))
    timed("prepare", system.prepare, events.rows, events.cols, events.vals,
          hold)
    timed("warm", kind.warm, system)
    setup_s = time.perf_counter() - clock_start

    off = lambda name: contextlib.nullcontext()
    measured = kind.window(system, seconds, off, collectors)
    profiled, summary = None, None
    if traced and measured.error is None:
        prof = trace.profile()
        record = _record()
        with prof:
            with record("window"):
                profiled = kind.window(system, 0, record, collectors)
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                       if d.type == "cuda"), default=0)
    if profiled is not None:
        start = time.perf_counter()
        summary = trace.summarize(prof)
        spans["trace_read"] = time.perf_counter() - start
    system.release()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    outputs = measured.outputs + (profiled.outputs if profiled else [])
    errors = [w.error for w in (measured, profiled)
              if w is not None and w.error is not None]
    ref = spec.reference(cell.entry["config"])
    start = time.perf_counter()
    problem = plain.make_problem(events.rows, events.cols, events.vals, hold)
    limits = cfg["limits"]
    if outputs:
        state = ref.prepare(problem, cfg, synthetic.torch_seed(seed), device)
        worst, failed = kind.judge(ref, state, problem, outputs, limits,
                                   traffic, device)
        del state
    else:
        worst, failed = {name: math.inf for name in limits}, 0
    reference_s = time.perf_counter() - start
    for error in errors:
        log.write(f"a window raised:\n{error}")
    failed += len(errors)
    checks = {name: (worst.get(name, math.inf), limit)
              for name, limit in limits.items()}
    correct = not errors and failed == 0 and all(
        judge.passes(value, limit) for value, limit in checks.values())

    line = {"correct": correct, "attempted": len(outputs) + len(errors),
            "failed": failed}
    if traced:
        line["metrics"] = _per_layer(cell, RunRecord(
            cell=cell, problem=problem, setup_spans=spans, window=measured,
            traced=profiled, trace=summary,
            model_flops=ref.model_flops(cfg, problem)))
    else:
        line["metrics"] = _reported(cell.end_to_end,
                                    dict(measured.values, setup_s=setup_s))
    line["device"] = _device(devices, memory_peak, summary)
    if summary is not None:
        line["breakdown"] = {
            "device_ops": [list(op) for op in summary.device_ops[:10]],
            "idle_gaps": [list(gap) for gap in summary.idle_gaps[:10]]}
    log.write(f"set-up {spans}; window {measured.values} over units "
              f"{[getattr(o, 'seconds', None) for o in measured.outputs]}; "
              f"reference {reference_s:.3f} s\n")
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in checks.items()}
    return Result(line=line, checks=checks)


def _reported(metrics, values) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics if m["name"] in values}


def _per_layer(cell, record_: RunRecord) -> dict:
    values = {}
    for metric in cell.per_layer:
        value = spec.metric_reader(metric["name"]).read(record_)
        if value is not None:
            values[metric["name"]] = value
    return _reported(cell.per_layer, values)


def _device(devices, memory_peak, summary) -> dict:
    device = devices[0]
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": len(devices), "memory_peak_bytes": memory_peak}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info
