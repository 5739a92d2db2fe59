"""The port's photo corpus and the programs that read it, on the CPU.

- `bench/corpus.load_corpus` gives tests/helpers/corpus.load_corpus's
  photos, names and order, byte for byte, at 96, 128, 256 and 1080; the
  manifest's sha256s hold; a missing or corrupt photo raises;
- `pil_bilinear_u8` gives Pillow's BILINEAR bytes on seeded random arrays
  (up, down, square and not, a side of 1, grey and RGB);
- `synthetic_alpha_init` gives the helper's (cv2's) bytes on every photo
  at 128, and its blur cv2.GaussianBlur's float64 bits;
- `bench/matting_oracle` agrees with tests/helpers/matting_oracle to 1e-12;
- `corpus_iou.run_image` at 96 on china and flower: the port's alpha
  against the JAX package's compat refine (as root bench/corpus_iou.py
  calls it) within test_torch_compat_matting's tolerance, mask IoU
  against the oracle >= 0.99, palette_quality_ok against sklearn;
- `bench.photo_batch` is root bench.py's tiling of the helper's corpus;
  BENCH_PHOTO=0 puts the synthetic run on stdout;
- each attribution micro prints one JSON line with its keys at a tiny
  shape.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from helpers import corpus as HC
from helpers import matting_oracle as HO
from image_segmenter_tpu_torch.bench import bench as BENCH
from image_segmenter_tpu_torch.bench import chip_envelope, corpus_iou
from image_segmenter_tpu_torch.bench import corpus as TC
from image_segmenter_tpu_torch.bench import matting_oracle as TO
from image_segmenter_tpu_torch.bench import micro_dbscan, micro_fit_sample, \
    micro_hsv_fit, micro_kmeans_restart, micro_u2netp_pack

torch.set_num_threads(2)

PIL = pytest.importorskip("PIL.Image")
NAMES = [e["name"] for e in TC.manifest()]
SIZES = (96, 128, 256, 1080)


@pytest.fixture(scope="module")
def corpora():
    """size -> (the helper's corpus, the port's), each loaded once."""
    pytest.importorskip("sklearn")
    pytest.importorskip("labmaze")
    cache = {}

    def get(size):
        if size not in cache:
            cache[size] = (HC.load_corpus(size=size),
                           TC.load_corpus(size=size))
        return cache[size]
    return get


def test_corpus_has_the_helpers_photos_in_its_order(corpora):
    ref, got = corpora(96)
    assert [n for n, _ in got] == [n for n, _ in ref] == NAMES
    assert len(NAMES) == 14


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_load_corpus_bytes_equal_the_helpers(corpora, size, name):
    ref, got = (dict(c) for c in corpora(size))
    assert got[name].dtype == np.uint8
    assert got[name].shape == (size, size, 3)
    assert np.array_equal(got[name], ref[name])


def test_manifest_sha256s_and_limit():
    entries = TC.manifest()
    assert [e["order"] for e in entries] == list(range(len(entries)))
    for e in entries:
        rgb = TC.read_photo(e)
        assert list(rgb.shape) == e["shape"] and e["shape"][2] == 3
        assert TC.rgb_sha256(rgb) == e["sha256"]
        assert e["licence"] and e["source"]
    assert [n for n, _ in TC.load_corpus(size=32, limit=3)] == NAMES[:3]


def test_missing_or_corrupt_photo_raises(tmp_path, monkeypatch):
    """No fallback: without the PNGs the loader and the bench's mosaic
    raise, and a PNG with other bytes than the manifest's raises."""
    flower = TC.CORPUS / "flower.png"
    shutil.copy(TC.MANIFEST, tmp_path / "MANIFEST.json")
    monkeypatch.setattr(TC, "CORPUS", tmp_path)
    monkeypatch.setattr(TC, "MANIFEST", tmp_path / "MANIFEST.json")
    with pytest.raises(FileNotFoundError):
        TC.load_corpus(size=32, limit=1)
    with pytest.raises(FileNotFoundError):
        BENCH.photo_batch(1, 32, 48)
    # another photo's bytes under china's name: decodes, but not to china
    shutil.copy(flower, tmp_path / "china.png")
    with pytest.raises(ValueError, match="sha256"):
        TC.load_corpus(size=32, limit=1)


@pytest.mark.parametrize("src,dst,channels", [
    ((40, 40), (17, 17), 3), ((40, 40), (97, 97), 3), ((37, 53), (20, 90), 3),
    ((53, 37), (120, 11), 3), ((31, 29), (1, 1), 3), ((31, 29), (1, 40), 3),
    ((64, 48), (64, 100), 3), ((64, 48), (7, 48), 1), ((9, 300), (40, 23), 1),
])
def test_pil_bilinear_u8_is_pillows(src, dst, channels):
    rng = np.random.default_rng(sum(src) * 1000 + sum(dst))
    shape = src + ((channels,) if channels > 1 else ())
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(PIL.fromarray(img).resize(dst[::-1], PIL.BILINEAR))
    got = TC.pil_bilinear_u8(img, dst)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_synthetic_alpha_init_is_cv2s(corpora, name):
    pytest.importorskip("cv2")
    rgb = dict(corpora(128)[0])[name]
    assert np.array_equal(TC.synthetic_alpha_init(rgb),
                          HC.synthetic_alpha_init(rgb))


@pytest.mark.parametrize("hw", [(60, 80), (37, 53), (13, 170), (2, 9)])
def test_gaussian_blur13_binary_is_cv2s_float64(hw):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    core = (rng.random(hw) > 0.5).astype(np.uint8)
    ref = cv2.GaussianBlur(core * 255.0, (0, 0), 1.5)
    assert np.array_equal(TC.gaussian_blur13_binary(core), ref)


def test_cv_steps_match_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    gray = TC.rgb_to_gray_cv(rgb)
    assert np.array_equal(gray, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    t, _ = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    assert TC.otsu_threshold_cv(gray) == t
    core = (rng.random((61, 83)) > 0.6).astype(np.uint8)
    ref = cv2.morphologyEx(core, cv2.MORPH_CLOSE, np.ones((7, 7), np.uint8))
    assert np.array_equal(TC.morph_close_cv(core), ref)


def test_matting_oracle_copy_agrees(corpora):
    rgb = dict(corpora(96)[1])["china"][24:72, 24:72]
    img01 = rgb.astype(np.float64) / 255.0
    a = TC.synthetic_alpha_init(rgb)
    tri = TO.build_trimap_reference(a)
    assert np.array_equal(tri, HO.build_trimap_reference(a))
    lt, lh = TO.assemble_laplacian(img01), HO.assemble_laplacian(img01)
    assert abs(lt - lh).max() <= 1e-12
    np.testing.assert_allclose(TO.solve_alpha_reference(img01, tri),
                               HO.solve_alpha_reference(img01, tri),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["china", "flower"])
def test_run_image_against_jax_compat_and_oracle(corpora, name):
    pytest.importorskip("sklearn")
    from processing.matting_refine import refine_alpha_portrait as jax_refine
    from image_segmenter_tpu_torch.compat.matting_refine import \
        refine_alpha_portrait

    rgb = dict(corpora(96)[1])[name]
    rec = corpus_iou.run_image(name, rgb, device="cpu")
    assert rec["image"] == name and rec["mask_iou"] >= 0.99
    assert rec["palette_quality_ok"] is True
    assert rec["polish_converged"] is True and rec["f32_iters"] > 0
    assert "card_cpu_alpha_equal" not in rec
    a0 = TC.synthetic_alpha_init(rgb)
    ours = refine_alpha_portrait(rgb, a0, None, device="cpu")
    assert TC.rgb_sha256(ours)[:16] == rec["alpha_sha256"]
    d = np.abs(ours.astype(np.int32) - jax_refine(rgb, a0, None))
    assert d.max() <= 1 and (d == 0).mean() >= 0.995
    json.dumps(rec)


def test_corpus_iou_main_writes_the_summary(tmp_path, capsys, monkeypatch):
    """main's records and summary (`run_image` stubbed: the test above
    runs the real one), with and without sklearn's fields."""
    calls = []

    def run_image(name, rgb, device="cuda"):
        calls.append((name, rgb.shape, str(device)))
        rec = {"image": name, "mask_iou": 0.995 if calls[1:] else 1.0,
               **dict.fromkeys(corpus_iou.PALETTE_FIELDS)}
        if len(calls) > 2:  # the second run: sklearn's fields present
            rec.update(palette_gap_wmean=1.0, label_agreement=0.5,
                       kmeans_sse_ratio=1.0, kmeans_rms_delta_u8=0.0,
                       palette_quality_ok=True, rms_floor_applied=False)
        return rec
    monkeypatch.setattr(corpus_iou, "run_image", run_image)
    out = tmp_path / "ci.json"
    summaries = []
    for _ in range(2):
        assert corpus_iou.main(["--size", "32", "--limit", "2", "--out",
                                str(out)], device="cpu") == 0
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 3
        summary = json.loads(lines[-1])
        summaries.append(summary)
        assert json.loads(out.read_text())["summary"]["size"] == 32
        assert summary["n_images"] == 2 and summary["device"] == "cpu"
        assert summary["mask_iou_min"] == 0.995
        assert summary["frac_iou_ge_0.99"] == 1.0
    assert summaries[0]["palette_quality_all_ok"] is None
    assert summaries[0]["palette_reference"].startswith("not measured")
    assert summary["palette_quality_all_ok"] is True
    assert [c[0] for c in calls] == NAMES[:2] * 2
    assert calls[0][1:] == ((32, 32, 3), "cpu")


def _jax_mosaic(tiles, b, h, w, side=1080):
    """root bench.py:95-110's tiling, over the helper's corpus."""
    cols = -(-w // side)
    canvases = []
    for i in range(b):
        rows = [np.concatenate([tiles[(i + r * cols + c) % len(tiles)][1]
                                for c in range(cols)], axis=1)
                for r in range(-(-h // side))]
        canvases.append(np.concatenate(rows, axis=0)[:h, :w])
    return np.stack(canvases)


@pytest.mark.parametrize("b,h,w,tile", [
    (2, 40, 2500, 1080), (3, 1100, 70, 1080),
    (2, 220, 440, 96)])  # past the 14th tile: the modulus wraps
def test_photo_batch_is_the_jax_mosaic(corpora, monkeypatch, b, h, w, tile):
    monkeypatch.setattr(BENCH, "TILE", tile)
    ref = _jax_mosaic(corpora(tile)[0], b, h, w, tile)
    assert np.array_equal(BENCH.photo_batch(b, h, w), ref)


def test_bench_photo_0_puts_the_synthetic_run_on_stdout(monkeypatch, capsys):
    """BENCH_PHOTO=0: one measured run, of the synthetic batch, on stdout
    (`measure` stubbed: test_torch_bench.py runs the real one)."""
    for k, v in {"BENCH_H": "32", "BENCH_W": "48", "BENCH_BATCH": "1",
                 "BENCH_REPS": "3", "BENCH_SECONDARY": "none",
                 "BENCH_PHOTO": "0"}.items():
        monkeypatch.setenv(k, v)
    calls = []

    def measure(pipe, model, imgs, reps, tag="", content="synthetic"):
        calls.append((imgs.shape, reps, content))
        return dict.fromkeys(BENCH.FIELDS, 0) | {
            "metric": f"pipeline_{model}_matting_kmeans16_32x48_b1",
            "content": content}
    monkeypatch.setattr(BENCH, "measure", measure)
    monkeypatch.setattr(BENCH, "photo_batch", None)  # never asked for
    assert BENCH.main([], device="cpu") == 0
    captured = capsys.readouterr()
    (line,) = captured.out.splitlines()
    rec = json.loads(line)
    assert calls == [((1, 32, 48, 3), 3, "synthetic")]
    assert rec["content"] == "synthetic" and rec["card"] == "cpu"
    assert rec["metric"] == "pipeline_u2netp_matting_kmeans16_32x48_b1"
    assert "[bench] synthetic {" not in captured.err


@pytest.mark.parametrize("mod,argv,keys", [
    (micro_kmeans_restart, ["--points", "64", "--compat-points", "128",
                            "--reps", "1"],
     {"rows", "restart_orders_bit_equal"}),
    (micro_fit_sample, ["--b", "1", "--h", "32", "--w", "48", "--points",
                        "256", "--reps", "1"], {"rows"}),
    (micro_hsv_fit, ["--h", "16", "--w", "24", "--reps", "1"],
     {"fit", "one_iteration", "implied_iterations", "one_iteration_bytes",
      "fused_pass_bytes"}),
    (micro_dbscan, ["--n", "300", "--buckets", "320", "--reps", "1"],
     {"ms", "clusters", "noise"}),
    (chip_envelope, ["--n", "32", "--k", "2", "--mb", "1", "--copies", "2",
                     "--reps", "1"],
     {"matmul_bf16_tflops", "matmul_f32_tflops", "copy_gbs", "datasheet"}),
    (micro_u2netp_pack, ["--b", "1", "--size", "32", "--reps", "1"],
     {"ms", "gflop_per_forward", "mb_moved_per_forward", "tflops", "gbs"}),
])
def test_micro_prints_one_line(mod, argv, keys, capsys):
    assert mod.main(argv, device="cpu") == 0
    (line,) = capsys.readouterr().out.splitlines()
    rec = json.loads(line)
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert keys <= set(rec), keys - set(rec)
