"""One run of one cell: `python3 dspbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`.

Everything about a cell is data found by name: the cell in
BENCHMARK.json names its configuration (`configs/<name>.json`, whose
"system" names `systems/<system>.py`) and its traffic mix
(`traffic/<name>.json`); each per-layer metric is read by
`metrics/<name>.py`.  A run builds the system, warms up the cell's own
shapes, feeds it blocks for --seconds through the closed loop
(`loop.py`), then, with --trace 1, profiles a few more blocks; reads the
device's memory peak, frees the program's state and holds what the
window produced against the plain reference.  The last line of standard
output is one JSON object; the numbers compared and their limits are
the last lines of standard error and the result's last key.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

from . import profile
from .bound import bound_s
from .loop import Loop

__all__ = ["main", "run_cell", "ROOT", "BENCH_DIR"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "liquid_dsp_tpu")


class RunError(Exception):
    """A run that cannot give a result: exit non-zero, print none."""


def load_named(folder: str, name: str) -> dict:
    path = BENCH_DIR / folder / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {folder[:-1]} named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_reader(name: str):
    """metrics/<name>.py's `read(ctx)`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"dspbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return (cell, load_named("configs", cell["config"]),
            load_named("traffic", cell["traffic"]))


def _cell_metrics(bench, cell, kind):
    """The cell's end-to-end or per-layer metrics (their "workloads", or
    for a per-layer metric without one, every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def set_caches():
    """Every build and kernel cache the program could use, at fixed
    paths inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class Context:
    """What a per-layer metric reader may read: the traced blocks
    (`trace`, a `profile.Trace`, None without --trace 1), the window's
    per-block enqueue and latency seconds, its blocks and seconds, the
    cell's work (`shapes`, from its system) and `bound_s`."""

    def __init__(self, trace, enqueue_s, latency_s, window_s, shapes):
        self.trace, self.enqueue_s, self.latency_s = trace, enqueue_s, latency_s
        self.window_s, self.shapes = window_s, shapes
        self.bound_s = bound_s
        self.profile = profile

    def kernel_s(self, pattern: str):
        """(device seconds, launches) of the traced operations whose name
        holds `pattern`, or None where there are none."""
        hits = [b - a for name, a, b in self.trace.device if pattern in name]
        return (sum(hits), len(hits)) if hits else None


def run_cell(workload, seed, seconds, trace, variant="program",
             device=None, t_start=None, bench=None):
    """One run; returns the result dict (the contract's line) and the
    checks.  `device` skips the look for a card (the harness's tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic = cell_spec(bench, workload)
    set_caches()
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false: this "
                           "benchmark runs on a CUDA card")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA cards, the "
                           f"cell asks for {cell['chips']}")
        device = torch.device("cuda", 0)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    system = importlib.import_module(f"dspbench.systems.{cfg['system']}")
    sysm = system.build(torch, cfg, traffic, seed, device, variant)
    loop = Loop(sysm, torch.profiler.record_function)
    # set-up: every shape of the cell once, the allocator's cache warm
    loop.run(n=traffic["warmup_blocks"])
    sysm.warm_allocator()
    if device.type == "cuda":
        torch.cuda.synchronize()
    sysm.start_window(loop.next_block)
    t0, t1, lat, enq = loop.run(seconds=seconds)
    consume_s = loop.consume_s
    sysm.stop_window()
    n_blocks, window_s = len(lat), t1 - t0
    result = {"correct": False, "attempted": n_blocks, "failed": 0,
              "metrics": {}, "device": {}}
    tr = None
    if trace:
        tr = profile.take_trace(torch, lambda n: loop.run(n=n, spans=True),
                                traffic["trace_blocks"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    values = {"msps": n_blocks * sysm.block_samples / window_s / 1e6,
              "setup_s": t0 - t_start}
    if trace:
        ctx = Context(tr, enq, lat, window_s, sysm.shapes())
        for m in _cell_metrics(bench, cell, "per_layer"):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in _cell_metrics(bench, cell, "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        w0, w1 = profile.window(tr)
        result["device"]["busy_s"] = profile.busy_s(tr)
        result["device"]["window_s"] = w1 - w0
        by_name = {}
        for name, a, b in tr.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                profile.idle_gaps(tr), key=lambda kv: -kv[1])[:10]]}
    # the program's state freed, then the reference
    sysm.release()
    del loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = sysm.check(traffic["limits"])
    ref_s = time.perf_counter() - t_ref
    result["attempted"] = getattr(sysm, "attempted", n_blocks)
    result["failed"] = int(failed)
    result["correct"] = bool(failed == 0 and all(
        lim is not None and v == v and v <= lim
        for v, lim in checks.values() if lim is not None))
    # a number that could not be read is null, and not correct
    result["checks"] = {k: {"value": None if v != v else v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    info = {"blocks": n_blocks, "window_s": window_s,
            "enqueue_ms": 1e3 * statistics.fmean(enq),
            "consume_ms": 1e3 * statistics.fmean(consume_s),
            "reference_s": ref_s, "variant": variant,
            "readings": getattr(sysm, "readings", {})}
    return result, info


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card():
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def main(argv=None, t_start=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default="program",
                    help="program (default); control: the reference in "
                    "TF32 in the program's place; control:bf16: the "
                    "program's own bfloat16 path; fault:state|half|answer: "
                    "a fault planted under the timed path")
    args = ap.parse_args(argv)
    try:
        result, info = run_cell(args.workload, args.seed, args.seconds,
                                args.trace, args.variant, t_start=t_start)
    except RunError as e:
        print(f"dspbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"dspbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"card: {_card()}; {json.dumps(info)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
