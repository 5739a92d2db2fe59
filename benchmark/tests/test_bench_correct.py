"""`correct` comes out false where it should: a run driven on the CPU at a
small size (the harness's look for a card skipped), with the timed path
broken underneath, against the cell's own limits. Also, on the card, the
control at the cell's own size."""

import time

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.reference.pipeline_run import Reference, judge
from benchmark.yardstick import weights

CELL = "u2netp_photo_1080p_b1"


def _plan():
    plan = R.Plan(R.load_manifest(), CELL, False)
    # at 270 x 480 the CG moves the alpha by much more than the limit;
    # at a few dozen rows its part would hide in the CNN's rounding
    plan.traffic = dict(plan.traffic, frames=2, height=270, width=480,
                        tile=270, check_calls=2, trace_calls=1)
    return plan


def _run(plan):
    return R.run_cell(plan, seed=2**31 + 11, seconds=0.01, trace=False,
                      devices=["cpu"], t0=time.perf_counter())


def test_a_sound_run_is_correct():
    res = _run(_plan())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"mp_per_s", "latency_ms_p95", "setup_s"}


def test_the_control_in_the_programs_place_is_not_correct(monkeypatch):
    plan = _plan()
    cfg = plan.config
    ctrl = Reference(cfg, weights.make_state(cfg["arch"], cfg["weight_seed"],
                                             "cpu"), "cpu", control=True)
    monkeypatch.setattr(plan.entry.Entry, "__call__",
                        lambda self, batch: ctrl(batch))
    res = _run(plan)
    assert not res["correct"], res["checks"]


def test_a_cg_step_that_keeps_its_state_is_caught(monkeypatch):
    from image_segmenter_tpu_torch.solvers import matting

    monkeypatch.setattr(matting.CGLoop, "step",
                        lambda self: self.flag.fill_(False))
    res = _run(_plan())
    assert not res["correct"]
    assert res["checks"]["alpha_mad"]["value"] > \
        res["checks"]["alpha_mad"]["limit"]


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from image_segmenter_tpu_torch.pipeline import segment as S

    run = S.Pipeline.run

    def half(self, imgs):
        out = run(self, imgs[: len(imgs) // 2])
        return S.PipelineOutput(*(torch.cat([t, t]) for t in out))

    monkeypatch.setattr(S.Pipeline, "run", half)
    assert not _run(_plan())["correct"]


def test_a_palette_altered_where_it_is_made_is_caught(monkeypatch):
    from image_segmenter_tpu_torch.pipeline import segment as S

    fit = S._kmeans16_fit_program

    def altered(sample, wts, k):
        c = (yield from fit(sample, wts, k)).clone()
        c[:, 0] = torch.where(c[:, 0] < 255, c[:, 0] + 1, c[:, 0] - 1)
        return c

    monkeypatch.setattr(S, "_kmeans16_fit_program", altered)
    res = _run(_plan())
    assert not res["correct"]
    assert res["checks"]["palette_mismatch"]["value"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the "
                    "card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_on_the_card_the_program_passes_and_the_control_fails(card):
    plan = R.Plan(R.load_manifest(), CELL, False)
    cfg = plan.config
    state = plan.entry.weights(cfg, [card])
    batches = plan.generator.make(plan.traffic, 0, [card])
    entry = plan.entry.Entry(cfg, plan.traffic, state, [card])
    ref = Reference(cfg, state, card)
    ctrl = Reference(cfg, state, card, control=True)
    for o in (0, 5, 9):
        out = entry(batches[o])
        got = judge(batches[o], out, ref)
        entry.release(out)
        bad = judge(batches[o], ctrl(batches[o]), ref)
        assert all(got[k] <= lim for k, lim in plan.limits.items()), got
        assert any(bad[k] > lim for k, lim in plan.limits.items()), bad
    assert np.isfinite(got["alpha_mad"])
