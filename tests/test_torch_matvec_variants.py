"""The two remaining matvec variants of the port against the JAX package.

K5 (`kernels.matvec.matvec_stack`, the padded 13-plane stack) and K6
(`kernels.matting.matvec_planes`, window means recomputed) run here through
their plain versions, which repeat the TPU kernels' arithmetic; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU. Operands are uniform-random images, as in those tests:
photo-like windows are near rank-deficient and their 1/eps-scale factors
amplify the rounding difference between any two orders of evaluation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.kernels import pallas_matting as JK6
from image_segmenter_tpu.kernels import pallas_matvec as JK5
from image_segmenter_tpu.kernels.pallas_precompute import precompute_planes
from image_segmenter_tpu.solvers import matting as JMAT
from image_segmenter_tpu_torch.bench import micro_matvec as BENCH
from image_segmenter_tpu_torch.kernels import matting as TK6
from image_segmenter_tpu_torch.kernels import matvec as TMV
from image_segmenter_tpu_torch.kernels import precompute as TP

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)


def _t(x):
    """jax or numpy array -> torch tensor that owns its memory."""
    return torch.from_numpy(np.array(x))


def _chw(x_hwc):
    return _t(x_hwc).permute(2, 0, 1).contiguous()


def _operands(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    p = rng.standard_normal((h, w)).astype(np.float32)
    pre = JMAT._precompute(jnp.asarray(img), 1e-7, 1, half_stats=True)
    ref = np.asarray(JMAT._matvec(pre, jnp.asarray(p), 1))
    return img, p, pre, ref


@pytest.mark.parametrize("hw", [(24, 40), (33, 130), (16, 128)])
def test_matvec_stack_plain_matches_jax(hw):
    """Plain K5 on a JAX-built stack: max|diff| / max|ref| < 1e-6 against
    the interpret-mode Pallas kernel it mirrors (same order of operations;
    XLA contracts some products into FMAs, torch on the CPU does not), and
    < 1e-5 against the JAX XLA `_matvec`, the JAX tests' own bound."""
    img, p, pre, ref = _operands(11, *hw)
    stack = JK5.build_matvec_stack(pre.image, pre.valid_n, pre.mu, pre.dinv)
    pallas = np.asarray(JK5.matvec_planes(stack, jnp.asarray(p)))
    got = TMV.matvec_stack(_t(stack), _t(p)).numpy()
    assert got.shape == hw
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(got - pallas).max() / scale < 1e-6
    assert np.abs(got - ref).max() / scale < 1e-5
    # batched: each image as its own call
    two = TMV.matvec_stack(_t(stack)[None].repeat(2, 1, 1, 1),
                           torch.stack([_t(p), -_t(p)]))
    np.testing.assert_array_equal(two[0].numpy(), got)
    np.testing.assert_array_equal(two[1].numpy(), -got)


@pytest.mark.parametrize("hw", [(24, 40), (33, 130)])
def test_matvec_stack_builders_equal_jax_bytes(hw):
    """`build_matvec_stack` and `build_matvec_stack_planes` give the JAX
    package's bytes, and each other's (as the JAX tests hold), so stacks
    built by either package are interchangeable."""
    rng = np.random.default_rng(17)
    img = rng.random((*hw, 3)).astype(np.float32)
    planes = precompute_planes(jnp.asarray(img), 1e-7)
    dinv6 = jnp.moveaxis(planes[0:6], 0, -1)
    mu3 = jnp.moveaxis(planes[8:11], 0, -1)
    ref = np.asarray(JK5.build_matvec_stack(jnp.asarray(img), planes[7], mu3,
                                            dinv6))
    np.testing.assert_array_equal(
        np.asarray(JK5.build_matvec_stack_planes(jnp.asarray(img), planes)),
        ref)
    tp = _t(planes)[None]
    timg = _chw(img)[None]
    got = TMV.build_matvec_stack(timg, tp[:, 7], tp[:, 8:11], tp[:, 0:6])
    got_p = TMV.build_matvec_stack_planes(timg, tp)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got_p[0].numpy(), ref)


def test_matvec_stack_equals_k3_plain_bits():
    """On the same operands the plain K5 and the plain K3 give the same
    bits, as the two Pallas variants do in the JAX package."""
    rng = np.random.default_rng(19)
    img = _t(rng.random((2, 3, 33, 130)).astype(np.float32))
    p = _t(rng.standard_normal((2, 33, 130)).astype(np.float32))
    planes = TP.precompute_planes(img, 1e-7)
    stack = TMV.build_matvec_stack_planes(img, planes)
    assert torch.equal(TMV.matvec_stack(stack, p),
                       TMV.matvec_planes(planes, img, p))
    with pytest.raises(ValueError):
        TMV.matvec_stack(stack[:, :12], p)
    with pytest.raises(ValueError):
        TMV.matvec_stack(stack[:, :, :36], p)


@pytest.mark.parametrize("hw", [(37, 53), (80, 129)])
def test_matvec_recompute_plain_matches_jax(hw):
    """Plain K6: `pack_static` and `pad_p` give the JAX package's bytes;
    the matvec is within 1e-6 of max|ref| of the interpret-mode Pallas
    kernel over its WHOLE output (the partial sums it leaves next to the
    image included), and within 1e-5 of the JAX XLA `_matvec` inside the
    image."""
    h, w = hw
    img, p, pre, ref = _operands(5, h, w)
    st = JK6.pack_static(jnp.ones((h, w), jnp.float32), jnp.asarray(img),
                         pre.dinv)
    pp = JK6.pad_p(jnp.asarray(p))
    pallas = np.asarray(JK6.matvec_planes(pp, st))
    tst = TK6.pack_static(torch.ones(h, w), _chw(img), _chw(pre.dinv))
    tpp = TK6.pad_p(_t(p))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(st))
    np.testing.assert_array_equal(tpp.numpy(), np.asarray(pp))
    got = TK6.matvec_planes(tpp, tst).numpy()
    assert got.shape == pallas.shape
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(got - pallas).max() / scale < 1e-6
    assert np.abs(got[:h, :w] - ref).max() / scale < 1e-5
    # batched: each image as its own call
    two = TK6.matvec_planes(torch.stack([tpp, -tpp]),
                            torch.stack([tst, tst]))
    np.testing.assert_array_equal(two[0].numpy(), got)
    np.testing.assert_array_equal(two[1].numpy(), -got)
    with pytest.raises(ValueError):
        TK6.matvec_planes(tpp, tst[:9])


def test_micro_matvec_bench_runs_on_the_cpu():
    """The variant bench: four finite rows; after 3 fed-back matvecs each
    variant's iterate is within 1e-5 of the plain loop's."""
    rows = BENCH.run(device="cpu", b=1, h=32, w=48, inner=3)
    assert [r["name"].split()[0] for r in rows] == ["plain", "K3", "K5", "K6"]
    for r in rows:
        assert np.isfinite(r["ms_per_matvec"]) and r["ms_per_matvec"] > 0
        assert r["drift"] < 1e-5
