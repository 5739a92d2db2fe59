"""The port's measuring programs (image_segmenter_tpu_torch/bench/bench.py,
profile_stages.py, baseline_configs.py, grabcut_parity.py) on the CPU at
small sizes, and their inputs against the JAX package's programs.

- `bench.synthetic_batch` equals root bench/baseline_configs._photo (the
  recipe of root bench.py:75-85) broadcast to the batch, byte for byte;
- `bench.main(device="cpu")` prints exactly one stdout line, the photo
  run, which parses and holds every field, and the synthetic run on
  stderr; a bench round's output is `Pipeline.run`'s, bit for bit;
  without a card and without device="cpu" it raises;
- `profile_stages.profile` returns every stage row, and its chained steps
  and its compiled row give the eager full run's bytes (it raises
  otherwise); `main` with `--photo` profiles the photo mosaic;
- `sweep_chunks.main` prints one line with a row a chunk size, equal
  bytes and the loops' host reads;
- each BASELINE config returns its keys and names its content (config
  1 with the k-means quantizer stubbed: its seconds on the CPU are spent
  in a fit that test_torch_color_simplify.py holds to JAX);
- `grabcut_parity.scene_case` gives the JAX sweep's scene bytes, one rect
  case gives the JAX package's `grabcut_core` mask, and the sweep's
  energy equals the JAX package's `mask_energy` within 1e-6 relative.
The JAX-side programs are imported from their files; the port never
imports them.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu.solvers import grabcut as JG
from image_segmenter_tpu_torch.bench import baseline_configs as BC
from image_segmenter_tpu_torch.bench import bench as BENCH
from image_segmenter_tpu_torch.bench import grabcut_parity as GP
from image_segmenter_tpu_torch.bench import profile_stages as PS
from image_segmenter_tpu_torch.bench import sweep_chunks as SC
from image_segmenter_tpu_torch.compat import color_simplify as CS
from image_segmenter_tpu_torch.pipeline.segment import Pipeline
from image_segmenter_tpu_torch.utils import profiling as PROF

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = {"BENCH_H": "64", "BENCH_W": "96", "BENCH_BATCH": "1",
        "BENCH_REPS": "1", "BENCH_SECONDARY": "none"}


def _jax_program(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", ROOT / "bench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_configs():
    return _jax_program("baseline_configs")


@pytest.fixture(scope="module")
def jax_parity():
    pytest.importorskip("cv2")
    return _jax_program("grabcut_parity")


@pytest.fixture
def tiny_env(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("hw", [(64, 96), (33, 50)])
def test_synthetic_batch_is_the_jax_bench_recipe(jax_configs, hw):
    h, w = hw
    ref = np.broadcast_to(jax_configs._photo(h, w, 0), (3, h, w, 3))
    got = BENCH.synthetic_batch(3, h, w, 0)
    assert got.dtype == np.uint8 and got.shape == (3, h, w, 3)
    assert np.array_equal(got, ref)


def test_bench_main_prints_one_line(tiny_env, capsys):
    assert BENCH.main([], device="cpu") == 0
    captured = capsys.readouterr()
    out = captured.out
    lines = out.splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(BENCH.FIELDS) <= set(rec), set(BENCH.FIELDS) - set(rec)
    assert rec["metric"] == "pipeline_u2netp_matting_kmeans16_64x96_b1_photo"
    assert rec["unit"] == "MP/sec/chip"
    assert rec["content"] == "photo"
    synthetic = [json.loads(line.split(" ", 2)[2])
                 for line in captured.err.splitlines()
                 if line.startswith("[bench] synthetic {")]
    assert len(synthetic) == 1 and synthetic[0]["content"] == "synthetic"
    assert synthetic[0]["metric"] == "pipeline_u2netp_matting_kmeans16_64x96_b1"
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert rec["value"] > 0 and rec["device_resident_mp_s"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 50.0)
    assert rec["rounds"] == BENCH.ROUNDS >= 5
    for key in ("spread", "device_resident_spread"):
        assert rec[key]["min"] <= rec[key]["max"]
    assert rec["spread"]["min"] <= rec["ms_per_batch"] <= rec["spread"]["max"]
    # no host-to-device copy on the CPU; the plain versions launch nothing
    assert rec["h2d_gbs"] == {"pre": None, "post": None}
    assert set(rec["launches"]) == set(BENCH.MAIN_PATH_KERNELS)
    assert not any(rec["launches"].values())


def test_bench_round_output_is_pipeline_run():
    pipe = Pipeline(model="u2netp", k=16, device="cpu")
    imgs = BENCH.synthetic_batch(2, 64, 96)
    secs, out = BENCH.stream_round(pipe, imgs, 2)
    ref = Pipeline(model="u2netp", k=16, device="cpu").run(imgs)
    assert secs > 0
    for name in ref._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_bench_main_without_a_card_raises(tiny_env, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BENCH.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0), ([(0, 2)], 2.0), ([(0, 2), (1, 3)], 3.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0), ([(5, 6), (0, 1), (0.5, 2)], 3.0),
    ([(0, 1), (1, 2)], 2.0)])
def test_busy_is_the_union_of_device_intervals(intervals, busy):
    assert PROF.busy_us(intervals) == busy


def test_profile_stages_rows():
    res = PS.profile("cpu", b=1, h=64, w=96, reps=1, matting_dim=48)
    stages = [r["stage"] for r in res["rows"]]
    assert stages == [
        "ingest (host -> device)", "resize 64x96 -> 320x320 (Lanczos)",
        "cnn u2netp 320x320 b1", "mask 320x320 -> 64x96 (Lanczos)",
        "AREA 64x96 -> 32x48", "trimap", "matting CG 32x48",
        "alpha 32x48 -> 64x96 (LINEAR)", "Otsu + close/open",
        "colour sample", "k-means fit k16", "palette map", PS.FULL_RUN,
        PS.COMPILED_RUN]
    for r in res["rows"]:
        assert r["ms"] > 0 and len(r["ms_all"]) == 1
        assert r["device_busy_ms"] is None and r["device_ops"] is None
    cg = res["rows"][6]
    assert len(cg["cg_iters"]) == 1 and cg["k3_launches"] == 0
    assert res["sum_stages_ms"] == pytest.approx(
        sum(r["ms"] for r in res["rows"][1:-2]))
    assert res["full_ms"] == res["rows"][-2]["ms"]
    assert res["compiled_ms"] == res["rows"][-1]["ms"]
    for p in ("", "compiled_"):
        assert res[p + "busy_share"] is None and res[p + "idle_share"] is None
        assert res[p + "idle_share_unprofiled"] is None
    assert res["card"] == "cpu" and not any(res["launches"].values())
    json.dumps(res)


def test_profile_stages_main_photo(capsys):
    assert PS.main(["64", "96", "1", "1", "--photo"], device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["content"] == "photo" and res["shape"] == [1, 64, 96]
    assert [r["stage"] for r in res["rows"]][-2:] == [PS.FULL_RUN,
                                                      PS.COMPILED_RUN]


def test_sweep_chunks_line(capsys):
    argv = ["--chunks", "1,3", "--content", "synthetic", "--reps", "1",
            "--b", "1", "--h", "64", "--w", "96"]
    assert SC.main(argv, device="cpu") == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(line)
    assert rec["micro"] == "sweep_chunks" and rec["same_bytes"]
    assert [r["chunk"] for r in rec["rows"]] == [1, 3]
    for r in rec["rows"]:
        n = r["chunk"]
        assert r["host_reads"] == (-(-r["cg_iters"] // n) + 1
                                   + -(-r["lloyd_iters"] // n) + 1)
        assert r["k3_launches"] == 0 and r["ms"] > 0
    assert rec["rows"][0]["cg_iters"] == rec["rows"][1]["cg_iters"] > 0


@pytest.mark.parametrize("config,kwargs,keys", [
    (1, {"h": 32, "w": 48}, {"mp_per_call", "s_per_call", "times_s"}),
    (2, {"h": 48, "w": 64, "b": 2}, {"mp_per_batch", "per_algorithm"}),
    (3, {"h": 48, "w": 64}, {"mp_per_call", "per_algorithm"}),
    (4, {"size": 64, "n": 1, "iterations": 2},
     {"mp_total", "grabcut", "matting", "crops"}),
    (5, {"b": 1, "h": 64, "w": 96}, {"mp_per_batch", "s_per_batch",
                                     "times_s"}),
])
def test_baseline_config_records(config, kwargs, keys, monkeypatch):
    calls = []
    if config == 1:
        # the k-means quantizer itself is held to JAX in
        # test_torch_color_simplify.py; here, what config 1 asks of it
        def kmeans(rgba, k, preserve_alpha, device):
            calls.append((rgba.shape, k, preserve_alpha, str(device)))
            return rgba, np.zeros((k, 3), np.uint8)
        monkeypatch.setattr(CS, "simplify_colors_kmeans", kmeans)
    rec = BC.CONFIGS[config - 1](reps=1, device="cpu", **kwargs)
    assert rec["config"] == config
    if config == 1:
        assert rec["content"] == "quantizer_frame(32, 48, seed 11)"
        assert calls == [((32, 48, 4), 16, True, "cpu")] * 2
    assert {"desc", "content", "mp_s"} | keys <= set(rec)
    assert rec["content"] and rec["mp_s"] > 0
    if config == 2:
        assert set(rec["per_algorithm"]) == {"median_cut", "octree",
                                             "threshold"}
    if config == 3:
        per = rec["per_algorithm"]
        assert set(per) == {"perceptual", "adaptive_distance",
                            "hsv_clustering"}
        assert "t_dbscan" in per["adaptive_distance"]["last_solve_info"]
        assert "t_fit" in per["hsv_clustering"]["last_solve_info"]
    if config == 4:
        assert rec["crops"] == ["china"] and "64x48" in rec["desc"]
        assert "cut_iters" in rec["grabcut"]["last_solve_info"]
        assert "f32_iters" in rec["matting"]["last_solve_info"]
    json.dumps(rec)


@pytest.mark.parametrize("s", [0, 7])
def test_grabcut_parity_scene_is_the_jax_sweeps(jax_parity, s):
    rng = np.random.default_rng(1000 + s)
    noise = rng.uniform(6, 20)
    ref_img, ref_blob = jax_parity._scene(rng, noise=noise)
    img, blob, got_noise = GP.scene_case(s)
    assert got_noise == noise
    assert np.array_equal(img, ref_img) and np.array_equal(blob, ref_blob)


def test_grabcut_parity_rect_case_is_jax_grabcut_core():
    img, _, _ = GP.scene_case(0)
    x, y, w, h = GP.rect_of(img)
    init = np.full(img.shape[:2], JG.BGD, np.uint8)
    init[y:y + h, x:x + w] = JG.PR_FGD
    ref = np.asarray(JG.grabcut_core(jnp.asarray(img), jnp.asarray(init),
                                     iterations=GP.ITERS))
    got = GP.ours(img, rect=(x, y, w, h))
    assert np.array_equal(got, ref)
    fg = GP._fg(got)
    e_jax = float(JG.mask_energy(jnp.asarray(img),
                                 jnp.asarray(fg, jnp.float32)))
    assert GP.energy(img, fg) == pytest.approx(e_jax, rel=1e-6)
