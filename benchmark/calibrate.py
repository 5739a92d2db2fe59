"""The readings a cell's limits are set from: the program and the control
on every batch the cell's traffic can send.

    python -m benchmark.calibrate --workload <cell>

One process, one set-up: for each batch offset (the traffic has as many
distinct batches as corpus photos, and a seed only chooses where a run
starts among them) the entry's call on the batch, as a run's window makes
it, is judged against the float32 reference (`judge`), and so is the
control: the reference at the precision below the configuration's
(`Reference(control=True)`) put in the program's place. The program's
alpha is also held against a witness, a reference whose CNN computes as
the configuration states (bfloat16): what is left there is not the
precision's. One JSON line an offset and side on standard output, then a
summary: for each number the largest reading of the program (the lower
reading) and the smallest of the control (the upper one). Not a run of
the benchmark: no window, no metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    R._cache_dirs()
    import torch

    from benchmark.yardstick import peaks

    if not torch.cuda.is_available():
        R.log("calibrate needs a CUDA device")
        return 2
    plan = R.Plan(R.load_manifest(), args.workload, False)
    cfg = plan.config
    devs = [torch.device("cuda:0")]
    dev = devs[0]
    batches = plan.generator.make(plan.traffic, 0, devs)
    state = plan.entry.weights(cfg, devs)
    entry = plan.entry.Entry(cfg, plan.traffic, state, devs)
    ref = plan.reference.Reference(cfg, state, dev)
    control = plan.reference.Reference(cfg, state, dev, control=True)
    witness = plan.reference.Reference(cfg, state, dev, cnn="bf16")
    rows = []
    for o, b in enumerate(batches):
        for who, fn in (("program", entry), ("control", control)):
            t = time.perf_counter()
            out = fn(b)
            t_out = time.perf_counter() - t
            t = time.perf_counter()
            got = plan.reference.judge(b, out, ref)
            row = {"offset": o, "who": who, **got, "call_s": t_out,
                   "judge_s": time.perf_counter() - t}
            if who == "program":
                row["iterations"] = entry.call_info()
                row["alpha_mad_vs_bf16_cnn"] = plan.reference.judge(
                    b, out, witness)["alpha_mad"]
                entry.release(out)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "card": peaks.card_label()}
    for k in plan.limits:
        prog = [r[k] for r in rows if r["who"] == "program"]
        ctrl = [r[k] for r in rows if r["who"] == "control"]
        summary[k] = {"lower": max(prog), "upper": min(ctrl)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
