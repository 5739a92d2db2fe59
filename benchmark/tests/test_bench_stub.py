"""A cell that shares nothing with `pipeline_run` runs through the same
harness: its configuration has no network and no matting shape, its
traffic names a generator of its own, and its entry, reference, limits
and metrics are files of their own under a root of their own. No file of
the harness is edited to run it."""

import json
import textwrap
import time

import pytest
import torch

from benchmark import run as R

FILES = {
    "BENCHMARK.json": {
        "command": ["python3", "-m", "benchmark.run"],
        "paths": ["benchmark"], "run_seconds": 1,
        "configs": [{"name": "stub_cfg", "source": "https://example.org",
                     "file": "benchmark/configs/stub_cfg.json",
                     "reduced": [], "why": "a stub"}],
        "workloads": [{"name": "stub_cell", "config": "stub_cfg",
                       "traffic": "stub_mix", "chips": 1, "why": "a stub"}],
        "end_to_end": [
            {"name": "rows_per_s", "unit": "rows/s", "better": "higher",
             "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "sums_per_call", "unit": "count", "better": "lower",
             "source": "program_counter", "layer": "stub",
             "moves": "rows_per_s"}]},
    "benchmark/configs/stub_cfg.json": {"entry": "stub_sum", "scale": 3},
    "benchmark/traffic/stub_mix.json": {"generator": "stub_rows",
                                        "rows": 5, "check_calls": 2,
                                        "trace_calls": 2},
    "benchmark/limits/stub_cell.json": {"limits": {"wrong": 0.0}},
    "benchmark/generators/stub_rows.py": """
        import numpy as np

        def make(traffic, seed, devices):
            rng = np.random.default_rng(seed)
            return [rng.integers(0, 9, traffic["rows"]) for _ in range(4)]
    """,
    "benchmark/entries/stub_sum.py": """
        def weights(config, devices):
            return None

        class Entry:
            def __init__(self, config, traffic, state, devices):
                self.scale, self.sums = config["scale"], 0

            def __call__(self, row):
                self.sums += 1
                return int(row.sum()) * self.scale

            def release(self, out):
                pass

            def warm_up(self, requests):
                self(requests[0])

            def work(self, row):
                return len(row)

            def counters(self):
                return {"sums": self.sums}

            def record(self):
                return {}

            def call_info(self):
                return []

            def close(self):
                pass
    """,
    "benchmark/reference/stub_sum.py": """
        class Reference:
            def __init__(self, config, state, device):
                self.scale = config["scale"]

        def judge(row, out, ref):
            return {"wrong": float(out != int(row.sum()) * ref.scale)}
    """,
    "benchmark/metrics/rows_per_s.py": """
        from benchmark.metrics.mp_per_s import read  # noqa: F401
    """,
    "benchmark/metrics/setup_s.py": """
        from benchmark.metrics.setup_s import read  # noqa: F401
    """,
    "benchmark/metrics/sums_per_call.py": """
        def read(run):
            return run["traced_counters"]["sums"] / run["traced_calls"]
    """,
}


@pytest.fixture
def root(tmp_path):
    for name, body in FILES.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body))
    return tmp_path


def _run(root, trace):
    plan = R.Plan(R.load_manifest(root), "stub_cell", trace, root)
    return plan, R.run_cell(plan, seed=2**31 + 5, seconds=0.05, trace=trace,
                            devices=["cpu"], t0=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_of_its_own_files_runs(root, trace):
    plan, res = _run(root, trace)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 2
    want = {"sums_per_call"} if trace else {"rows_per_s", "setup_s"}
    assert set(res["metrics"]) == want
    if trace:
        assert res["metrics"]["sums_per_call"]["value"] == 1.0
    else:
        assert res["metrics"]["rows_per_s"]["unit"] == "rows/s"
    assert res["device"]["count"] == 1 and list(res)[-1] == "checks"


def test_a_wrong_answer_of_the_stub_is_caught(root):
    path = root / "benchmark/entries/stub_sum.py"
    path.write_text(path.read_text().replace("* self.scale",
                                             "* self.scale + 1"))
    _, res = _run(root, False)
    assert not res["correct"] and res["checks"]["wrong"]["value"] == 1.0


@pytest.mark.parametrize("kind,name", [
    ("generators", "stub_rows.py"), ("entries", "stub_sum.py"),
    ("reference", "stub_sum.py"), ("limits", "stub_cell.json"),
    ("metrics", "rows_per_s.py")])
def test_a_missing_file_of_the_stub_is_named(root, kind, name):
    (root / "benchmark" / kind / name).unlink()
    with pytest.raises(FileNotFoundError, match=f"benchmark/{kind}/{name}"):
        R.Plan(R.load_manifest(root), "stub_cell", False, root)


def test_without_a_card_a_run_exits_2_and_prints_nothing(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "u2netp_photo_1080p_b1", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
