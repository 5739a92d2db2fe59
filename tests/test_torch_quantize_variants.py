"""The plain versions of kernels K7 (`quantize_flat`) and K8
(`hist_variants`) against the TPU kernels they replace, run in interpret
mode on the CPU, and against the port's K4 plain version and np.bincount.
u8 maps and integer counts: bit-equal.

The TPU kernels live in the repo's bench scripts; they are loaded by path
(bench/micro_quantize.py puts bench/ on sys.path itself for its helper
module).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.bench import micro_hist_nibble as TMH
from image_segmenter_tpu_torch.bench import micro_quantize as TMQ
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as K1
from image_segmenter_tpu_torch.kernels import quantize as K4
from image_segmenter_tpu_torch.kernels import quantize_flat as K7

torch.set_num_threads(2)
_BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench"
_BLOCK = 256 * 128  # the TPU kernels' block


@functools.lru_cache(maxsize=None)
def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}",
                                                  _BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quantize_case(h, w, k_real, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    rgb[0, 0, :4] = 30  # brightness exactly at the threshold
    alpha = ((rng.random((2, h, w)) > 0.2) * 255).astype(np.uint8)
    cent = rng.integers(0, 256, (16, 3)).astype(np.float32)
    cent[5] = cent[2]  # an exact tie: the first index wins
    return rgb, alpha, cent, k_real, np.float32(30.0)


# one TPU block exactly (128 x 256 pixels), and a ragged size
@pytest.mark.parametrize("h,w,k_real", [(128, 256, 16), (37, 53, 11)])
def test_quantize_flat_plain_matches_pallas_and_k4(h, w, k_real):
    rgb, alpha, cent, k_real, thr = _quantize_case(h, w, k_real, h)
    jq = _load("micro_quantize").quantize_map_flat
    trgb, talpha = torch.from_numpy(rgb), torch.from_numpy(alpha)
    tcent = torch.from_numpy(cent)[None].repeat(2, 1, 1)
    tthr = torch.full((2,), float(thr))
    got = K7.quantize_map_flat(trgb, talpha, tcent, k_real, tthr)
    assert got.dtype == torch.uint8 and got.shape == (2, h, w, 3)
    for i in range(2):
        ref = np.asarray(jq(jnp.asarray(rgb[i]), jnp.asarray(alpha[i]),
                            jnp.asarray(cent), jnp.int32(k_real),
                            jnp.float32(thr), k_max=16))
        np.testing.assert_array_equal(got[i].numpy(), ref)
    assert torch.equal(got, K4.quantize_map_plain(trgb, talpha, tcent, k_real,
                                                  tthr))
    assert torch.equal(got, K7.quantize_map_flat_plain(trgb, talpha, tcent,
                                                       k_real, tthr))


def test_quantize_planes_round_trip_and_checks():
    rgb, alpha, cent, k_real, thr = _quantize_case(9, 7, 16, 3)
    trgb = torch.from_numpy(rgb)
    planes = K7.split_planes(trgb)
    assert planes.shape == (3, 2, 63) and planes.is_contiguous()
    assert torch.equal(K7.stack_planes(planes, 9, 7), trgb)
    tcent = torch.from_numpy(cent)[None].repeat(2, 1, 1)
    with pytest.raises(ValueError):
        K7.quantize_planes(planes.to(torch.float32),
                           torch.from_numpy(alpha).reshape(2, 63), tcent, 16,
                           torch.full((2,), 30.0))
    with pytest.raises(ValueError):
        K7.quantize_map_flat(trgb[..., :2], torch.from_numpy(alpha), tcent,
                             16, torch.full((2,), 30.0))


def _tpu_kernel(variant):
    mod = _load("micro_hist_nibble")
    if variant == "N3D":
        return mod._kernel_n3d
    return mod._make_kernel(K8.STEPS[variant] // 128)


# two TPU blocks exactly, and a ragged n
@pytest.mark.parametrize("n", [2 * _BLOCK, _BLOCK + 777])
@pytest.mark.parametrize("variant", ["N32", "N256", "N3D"])
def test_hist_variant_plain_matches_pallas_and_bincount(variant, n):
    rng = np.random.default_rng(n)
    xh = rng.integers(0, 256, (2, n), dtype=np.uint8)
    xh[1, : n // 3] = 255  # a long run of one value
    got = K8.hist_variant(torch.from_numpy(xh), variant).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 256)
    jh = _load("micro_hist_nibble").hist_variant
    for i in range(2):
        ref = np.asarray(jh(jnp.asarray(xh[i]), kernel=_tpu_kernel(variant),
                            interpret=True))
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(
            got[i], np.bincount(xh[i], minlength=256).astype(np.float32))


@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_hist_variant_plain_matches_k1_plain(variant):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (3, 5000), dtype=np.uint8))
    assert torch.equal(K8.hist_variant(x, variant), K1.hist256_plain(x))
    one = torch.zeros((1, 1), dtype=torch.uint8)
    assert float(K8.hist_variant(one, variant)[0, 0]) == 1.0


def test_hist_variant_rejects_bad_input():
    x = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        K8.hist_variant(x, "N8")
    with pytest.raises(ValueError):
        K8.hist_variant(x.to(torch.int32), "N32")


def test_micro_benches_run_on_the_cpu():
    """The bench paths' plumbing on the plain versions: equal outputs,
    exact counts, no kernel launches off the card."""
    res = TMQ.run("cpu", 2, 37, 53, reps=1)
    assert res["equal"] and res["k4_launches"] == res["k7_launches"] == 0
    rows = TMH.run("cpu", _BLOCK + 777, 2, reps=1)
    assert len(rows) == 3 * (len(K8.STEPS) + 1)
    assert all(r["exact"] and r["launches"] == 0 for r in rows)
