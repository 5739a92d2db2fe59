"""The benchmark of image_segmenter_tpu_torch: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything is found by name from
`BENCHMARK.json`, each item in a file of its own:
- the cell names its configuration (`benchmark/configs/<config>.json`)
  and its traffic mix (`benchmark/traffic/<traffic>.json`);
- the mix names its generator (`benchmark/generators/<generator>.py`),
  whose `make(traffic, seed, devices)` returns the requests in the order
  the calls take them;
- the configuration names the entry the window drives
  (`benchmark/entries/<entry>.py`, whose docstring says what a run needs
  of it) and its reference (`benchmark/reference/<entry>.py`:
  `Reference(config, state, device)` and `judge(request, outputs, ref)`);
- every metric has its reader (`benchmark/metrics/<name>.py`);
- the cell's limits on the numbers that decide `correct` are in
  `benchmark/limits/<cell>.json`.
This file holds only what every cell shares: the set-up's clock, the
window, the reservoir of kept calls, the trace and the judgement.

A run:
1. exits with 2 and prints no result where PyTorch sees no CUDA device or
   fewer than the cell's chips;
2. makes the requests and the weights, builds the entry and warms it up
   on the traffic's shapes: all of that, from the start of the process,
   is `setup_s`;
3. runs a closed loop of one client for `--seconds`, the collector on as
   in a user's process: each call hands the next request to the entry and
   gets its outputs back on the host; a sample of the calls, drawn from
   the seed, keeps its outputs;
4. reads the peak device memory; with `--trace 1` runs the mix's
   `trace_calls` calls more under torch.profiler (the traced window);
5. frees the program, runs the reference over the kept calls and judges
   them against the cell's limits;
6. exits with 3 and prints no result if JAX, flax or the JAX package was
   loaded;
7. prints each number beside its limit as the last lines of standard
   error, and one JSON line as the last line of standard output.

The record a metric reader gets (`read(run)`): `config`, `traffic`,
`calls` [(start_s, end_s)] and `work` [work of each call] of the
completed calls, `setup_s`, `window_counters` (the entry's counters over
the window) and what the entry's `record()` adds; in a traced run also
`timeline` (yardstick/timeline.Timeline), `traced_calls`,
`traced_window_s`, `traced_counters` and `traced_info` (each traced
call's `call_info()`).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def item(kind: str, name: str, suffix: str = ".json",
         root: Path = ROOT) -> Path:
    """The file of `name` under benchmark/<kind>/; raises naming it where
    it is missing."""
    path = root / "benchmark" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file "
                                f"{path.relative_to(root)}")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    with open(item(kind, name, root=root)) as f:
        return json.load(f)


def module(kind: str, name: str, root: Path = ROOT):
    """The module in benchmark/<kind>/<name>.py, loaded from its file."""
    path = item(kind, name, ".py", root)
    key = f"benchmark.{kind}.{name}" if root == ROOT else \
        f"benchmark_at_{abs(hash(str(root)))}.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics of this kind of run: end-to-end without a trace,
    per-layer with one."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


class Plan:
    """Everything a run of one cell reads, found by name under `root`."""

    def __init__(self, bench: dict, workload: str, trace: bool,
                 root: Path = ROOT):
        self.cell = cell_of(bench, workload)
        self.config = load_json("configs", self.cell["config"], root)
        self.traffic = load_json("traffic", self.cell["traffic"], root)
        self.limits = load_json("limits", workload, root)["limits"]
        self.generator = module("generators", self.traffic["generator"],
                                root)
        self.entry = module("entries", self.config["entry"], root)
        self.reference = module("reference", self.config["entry"], root)
        self.metrics = [(m, module("metrics", m["name"], root))
                        for m in metrics_of(bench, workload, trace)]


def _reservoir(rng, m: int):
    """Algorithm R over call indices: keep(j) says whether call j joins
    the sample of m, and which slot it takes."""
    def keep(j: int):
        if j < m:
            return j
        r = int(rng.integers(0, j + 1))
        return r if r < m else None
    return keep


def _sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(plan: Plan, seed: int, seconds: float, trace: bool, devices,
             t0: float = T0) -> dict:
    """One run of plan's cell on `devices`; returns the result's fields
    and the check lines. Raises where the run cannot make a result."""
    import numpy as np
    import torch

    from benchmark.yardstick import timeline

    devices = [torch.device(d) for d in devices]
    cfg, tr = plan.config, plan.traffic
    requests = plan.generator.make(tr, seed, devices)
    n = len(requests)
    state = plan.entry.weights(cfg, devices)
    entry = plan.entry.Entry(cfg, tr, state, devices)
    entry.warm_up(requests)
    _sync(devices)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    m = tr["check_calls"]
    keep = _reservoir(np.random.default_rng(int(seed)), m)
    kept = [None] * m
    calls, work, failed = [], [], 0
    gc.collect()
    c0 = entry.counters()
    start = time.perf_counter()
    j = 0
    while True:
        req = requests[j % n]
        s = time.perf_counter()
        try:
            out = entry(req)
        except Exception:  # a call that fails counts, and the run goes on
            failed += 1
            log(f"call {j} failed:\n{traceback.format_exc()}")
            out = None
        e = time.perf_counter()
        if out is not None:
            calls.append((s, e))
            work.append(entry.work(req))
            slot = keep(j)
            if slot is None:
                entry.release(out)
            else:
                if kept[slot] is not None:
                    entry.release(kept[slot][1])
                kept[slot] = (j, out)
        j += 1
        if e - start >= seconds:
            break
    c1 = entry.counters()
    attempted = j
    if calls:
        ms = sorted((e - s) * 1e3 for s, e in calls)
        log(f"window: {len(calls)} calls of {attempted} in "
            f"{calls[-1][1] - calls[0][0]:.3f} s; call ms min {ms[0]:.3f} "
            f"median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}")
    cuda = [d for d in devices if d.type == "cuda"]
    run = {"config": cfg, "traffic": tr, "calls": calls, "work": work,
           "setup_s": setup_s,
           "window_counters": {k: c1[k] - c0[k] for k in c0},
           **entry.record()}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
        "count": len(devices),
        "memory_peak_bytes": max((torch.cuda.max_memory_allocated(d)
                                  for d in cuda), default=0)}
    breakdown = None
    if trace:
        info, span = [], []

        def traced():
            _sync(devices)
            span.append(time.perf_counter())
            for i in range(tr["trace_calls"]):
                entry.release(entry(requests[(j + i) % n]))
                info.append(entry.call_info())
            _sync(devices)
            span.append(time.perf_counter())

        ct0 = entry.counters()
        tl = timeline.capture(traced)
        ct1 = entry.counters()
        window = span[1] - span[0]
        run.update(timeline=tl, traced_calls=tr["trace_calls"],
                   traced_window_s=window, traced_info=info,
                   traced_counters={k: ct1[k] - ct0[k] for k in ct0})
        device_info.update(busy_s=timeline.busy_s_per_device(tl),
                           window_s=window)
        breakdown = _breakdown(tl)
    entry.close()
    del entry

    metrics = {}
    for m_, reader in plan.metrics:
        value = reader.read(run)
        if value is not None:
            metrics[m_["name"]] = {"value": value, "unit": m_["unit"]}

    ref = plan.reference.Reference(cfg, state, devices[0])
    numbers = {}
    for got_ in kept:
        if got_ is None:
            continue
        j_, out = got_
        got = plan.reference.judge(requests[j_ % n], out, ref)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in plan.limits.items()}
    correct = failed == 0 and bool(numbers) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _breakdown(tl) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark's host span around them and the
    operation before."""
    from benchmark.yardstick import timeline

    tot = {}
    for name, s, e in tl.device:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(tot.items(), key=lambda x: -x[1])[:10]
    gaps = [[f"{timeline.span_at(tl.spans, (a + b) / 2)}: after "
             f"{timeline.short_name(prev or '', 80)}", (b - a) / 1e6]
            for a, b, prev in timeline.idle_gaps(tl.device)[:10]]
    return {"device_ops": [[timeline.short_name(k), v] for k, v in ops],
            "idle_gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    bench = load_manifest()
    plan = Plan(bench, args.workload, bool(args.trace))

    import torch

    chips = plan.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); PyTorch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from benchmark.yardstick import guard, peaks

    log(f"card {peaks.card_label()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}; workload {args.workload} seed {args.seed} "
        f"seconds {args.seconds} trace {args.trace}")
    result = run_cell(plan, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(chips)])
    found = guard.forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
