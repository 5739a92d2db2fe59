"""The row split of the port's training step (parallel/spatial.py and
pipeline/train.shard_train_step over a space axis), on the CPU.

Every op of `parallel/spatial` is held to the same op on the whole tensor,
forward and input gradient, in float64 to 1e-12, on blocks over 1 to 4
slots: even, uneven and empty, and halos wider than a block. The whole
U^2-Netp step split over (1, 2), (1, 4) and a one-process (2, 2) is held
to the one-slot step in float64 to 1e-9, and in float32 to the JAX
package's row-split `shard_train_step` on two virtual CPU devices (GSPMD)
within the bounds tests/test_torch_train.py holds the two packages to.

The float64 sizes are 4 x 32 x 32 and 3 x 40 x 48. At 32 x 32 U^2-Netp's
innermost maps are 1 x 1, so a BatchNorm there normalises B numbers: at
batch 2 or 3 float64 rounding is amplified through those sets to 1e-9 -
6e-7 between two summation orders, and a single block (the same
arithmetic as the whole tensor, in another order) is as far from the
whole tensor as a split (measured: 2.7e-7 one block, 3.4e-7 two, batch 3).
At batch 4 the sets hold 4 numbers and every split agrees to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_segmenter_tpu.models import u2net as JU
from image_segmenter_tpu.parallel import mesh as JM
from image_segmenter_tpu.pipeline import train as JT
from image_segmenter_tpu_torch.models import u2net as U
from image_segmenter_tpu_torch.models.convert import state_from_flax
from image_segmenter_tpu_torch.parallel import mesh as PM
from image_segmenter_tpu_torch.parallel import spatial as S
from image_segmenter_tpu_torch.pipeline import train as TR

torch.set_num_threads(2)

CPU = torch.device("cpu")
F64 = torch.float64

# (H, row bounds): one slot, even, uneven, an empty block beside a 1-row
# one (a dilation-8 halo reaches over several blocks), four slots
BLOCKS = {
    "one": (10, [(0, 10)]),
    "even": (10, [(0, 5), (5, 10)]),
    "uneven": (10, [(0, 4), (4, 7), (7, 10)]),
    "empty": (10, [(0, 3), (3, 3), (3, 4), (4, 10)]),
    "four": (11, [(0, 2), (2, 5), (5, 8), (8, 11)]),
}


def _rows(x: torch.Tensor, bounds, groups: int = 1) -> S.Rows:
    """x split at `bounds` (its rows) over `groups` data groups."""
    return S.Rows([[x[b0:b1, :, lo:hi] for lo, hi in bounds]
                   for b0, b1 in PM.split_bounds(x.shape[0], groups)],
                  bounds, x.shape[2])


def _whole(r: S.Rows) -> torch.Tensor:
    return torch.cat([torch.cat(group, 2) for group in r.blocks], 0)


def _check(op_rows, op_whole, x: torch.Tensor, bounds, groups=1,
           tol=1e-12):
    """op on row blocks against op on the whole tensor: the output, and
    the input's gradient of a random projection of it."""
    x = x.detach().requires_grad_(True)
    got = _whole(op_rows(_rows(x, bounds, groups)))
    ref = op_whole(x)
    assert got.shape == ref.shape
    err = float((got - ref).detach().abs().max())
    assert err <= tol * float(ref.detach().abs().max())
    proj = torch.randn(ref.shape, dtype=F64,
                       generator=torch.Generator().manual_seed(1))
    g_got, = torch.autograd.grad((got * proj).sum(), x)
    g_ref, = torch.autograd.grad((ref * proj).sum(), x)
    assert float((g_got - g_ref).abs().max()) \
        <= tol * float(g_ref.abs().max())


def _x(b, c, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, c, h, w), dtype=F64, generator=g)


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("a,b", [(-3, 4), (2, 9), (-9, 14), (7, 13), (4, 5)])
def test_gather_zero_fill(case, a, b):
    """Rows [a, b) on a slot: the zero-padded whole tensor's rows, for
    ranges inside, across and past the edges, and their gradient."""
    h, bounds = BLOCKS[case]
    x = _x(2, 3, h, 5).requires_grad_(True)
    pad = F.pad(x, (0, 0, 16, 16))
    for j in range(len(bounds)):
        got = S.gather(_rows(x, bounds), 0, j, a, b)
        ref = pad[:, :, a + 16:b + 16]
        assert torch.equal(got, ref)
        g_got, = torch.autograd.grad(got.sum() * 1.5, x)
        g_ref, = torch.autograd.grad(ref.sum() * 1.5, x)
        assert torch.equal(g_got, g_ref)


@pytest.mark.parametrize("case", list(BLOCKS))
@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (3, 4), (3, 8),
                                        (1, 1)])
def test_conv(case, k, dilation):
    h, bounds = BLOCKS[case]
    x = _x(2, 3, h, 9)
    w = _x(4, 3, k, k, seed=2)
    b = _x(1, 1, 1, 4, seed=3).flatten()
    _check(lambda r: S.conv2d(r, w, b, dilation),
           lambda t: F.conv2d(t, w, b, padding=dilation * (k // 2),
                              dilation=dilation), x, bounds, groups=2)


@pytest.mark.parametrize("h,bounds", [
    (10, [(0, 10)]), (10, [(0, 5), (5, 10)]), (9, [(0, 3), (3, 6), (6, 9)]),
    (9, [(0, 1), (1, 2), (2, 2), (2, 9)]), (5, [(0, 2), (2, 3), (3, 4),
                                              (4, 5)])])
def test_maxpool(h, bounds):
    """The ceil-mode pool, odd heights and widths: a block whose first
    row is odd lends it to the block above, and a block may own no row
    of the next level."""
    _check(S.maxpool2, lambda t: F.max_pool2d(t, 2, 2, ceil_mode=True),
           _x(2, 3, h, 7), bounds, groups=2)


@pytest.mark.parametrize("hw_in,src,hw_out,out", [
    ((5, 6), [(0, 3), (3, 5)], (10, 12), [(0, 5), (5, 10)]),
    ((3, 7), [(0, 1), (1, 2), (2, 2), (2, 3)], (5, 9),
     [(0, 1), (1, 3), (3, 3), (3, 5)]),
    ((2, 2), [(0, 1), (1, 1), (1, 2), (2, 2)], (32, 32),
     [(0, 8), (8, 16), (16, 24), (24, 32)]),
    ((2, 3), [(0, 1), (1, 2)], (32, 48), [(0, 11), (11, 32)]),
    ((5, 5), [(0, 2), (2, 5)], (5, 9), [(0, 2), (2, 5)]),
])
def test_upsample(hw_in, src, hw_out, out):
    """Bilinear, align_corners=False, by 2, by 16, an odd ratio (3 to 5)
    and the width alone, onto blocks of the output's rows, with empty
    blocks on either side: F.interpolate on the whole tensor."""
    (hi, wi), (ho, wo) = hw_in, hw_out
    ref_rows = _rows(torch.zeros((2, 1, ho, wo), dtype=F64), out, 2)
    _check(lambda r: S.upsample(r, ref_rows),
           lambda t: F.interpolate(t, size=(ho, wo), mode="bilinear",
                                   align_corners=False),
           _x(2, 3, hi, wi), src, groups=2)


@pytest.mark.parametrize("case", list(BLOCKS))
def test_batch_norm_moments(case):
    """The training statistics summed over the blocks (and the groups) on
    the first slot: mean and Flax's E[y^2] - E[y]^2 of the whole tensor,
    and their gradient."""
    h, bounds = BLOCKS[case]
    x = (_x(3, 4, h, 6) * 2.0 + 0.5).requires_grad_(True)
    proj = _x(2, 4, 1, 1, seed=4).reshape(2, 4)
    got = torch.stack(U._moments(_rows(x, bounds, groups=2)))
    ref = torch.stack(U._moments(x))
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    g_got, = torch.autograd.grad((got * proj).sum(), x)
    g_ref, = torch.autograd.grad((ref * proj).sum(), x)
    assert float((g_got - g_ref).abs().max()) \
        <= 1e-12 * float(g_ref.abs().max())


def _f64_model():
    """U^2-Netp and its state in float64: a module cast by `.double()`
    computes in float64 throughout (models/u2net.py)."""
    module = U.U2NET(small=True)
    tx, st = TR.create_train_state(module, seed=0)
    module.double()
    st = st._replace(params={k: v.double() for k, v in st.params.items()},
                     batch_stats={k: v.double()
                                  for k, v in st.batch_stats.items()},
                     opt_state=tx.init({k: v.double()
                                        for k, v in st.params.items()}))
    return module, tx, st


def _batch64(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((b, 3, h, w))),
            torch.from_numpy((rng.random((b, h, w)) > 0.5).astype(np.float64)))


@pytest.mark.parametrize("bhw", [(4, 32, 32), (3, 40, 48)])
def test_row_split_step_float64(monkeypatch, bhw):
    """`shard_train_step` over (1, 2), (1, 4) and one process's (2, 2)
    against the one-slot step from one state, in float64: the loss and
    every gradient to 1e-9 relative (the conv biases ahead of a
    BatchNorm, 0 in exact arithmetic, to 1e-12 absolute), the new
    statistics to 1e-9, and the stepped parameters to 1e-8 absolute:
    Adam's first step divides a gradient by |g| + 1e-8, which turns the
    rounding of near-zero gradients into moves of up to 5e-9 (measured).
    Each step really splits: its forward runs on row blocks."""
    module, tx, st = _f64_model()
    imgs, masks = _batch64(*bhw)
    loss_1, g_1, s_1 = TR.loss_and_grads(module, st, imgs, masks)
    step = TR.make_train_step(module, tx)
    new_1, _ = step(st, imgs, masks)
    seen = []
    real = TR.loss_and_grads

    def spy(module, state, imgs, masks, global_batch=None):
        seen.append((type(imgs), len(imgs.flat())))
        return real(module, state, imgs, masks, global_batch)

    monkeypatch.setattr(TR, "loss_and_grads", spy)
    for shape in ((1, 2), (1, 4), (2, 2)):
        mesh = PM.make_mesh(shape, devices=[CPU] * 4)
        new, loss = TR.shard_train_step(step, mesh)(st, imgs, masks)
        assert seen.pop() == (S.Rows, shape[0] * shape[1])
        assert abs(float(loss) - float(loss_1)) <= 1e-9 * float(loss_1)
        # Adam's first moment after one step is 0.1 of the gradient
        for k, m in new.opt_state["mu"].items():
            g = m / 0.1
            if k.endswith("conv_s1.bias"):
                assert float(g.abs().max()) <= 1e-12, k
                continue
            assert float((g - g_1[k]).norm()) \
                <= 1e-9 * float(g_1[k].norm()), (shape, k)
        for k, v in new.batch_stats.items():
            assert float((v - s_1[k]).abs().max()) <= 1e-9, k
        for k, p in new.params.items():
            assert float((p - new_1.params[k]).abs().max()) <= 1e-8, k
        assert new.step == 1


def test_no_slot_holds_more_than_its_rows_and_halo(monkeypatch):
    """A row-split forward and backward of U^2-Netp (40 x 48 over four
    slots): every block holds exactly its level's rows, and every read
    of another block's rows stays within 8 rows (the widest halo, a
    dilation-8 convolution) of the reader's own block at that level."""
    reads = []
    real = S.gather

    def spy(x, g, j, a, b):
        lo, hi = x.bounds[j]
        reads.append((a - lo, b - hi, x.height))
        return real(x, g, j, a, b)

    monkeypatch.setattr(S, "gather", spy)
    module = U.U2NET(small=True)
    tx, st = TR.create_train_state(module, seed=0)
    imgs, masks = (t.float() for t in _batch64(2, 40, 48))
    mesh = PM.make_mesh((1, 4), devices=[CPU] * 4)
    TR.shard_train_step(TR.make_train_step(module, tx), mesh)(st, imgs,
                                                              masks)
    assert reads
    assert all(-8 <= lo_gap and hi_gap <= 8 for lo_gap, hi_gap, _ in reads)
    # the split reaches the innermost level (40 -> 20 -> 10 -> 5 -> 3 -> 2)
    assert {h for _, _, h in reads} >= {40, 20, 10, 5, 3, 2}


def test_a_batch_smaller_than_the_data_groups_is_refused():
    """Not gathered onto fewer slots: refused before any work."""
    module = U.U2NET(small=True)
    tx, st = TR.create_train_state(module, seed=0)
    step = TR.make_train_step(module, tx)
    imgs, masks = (t.float() for t in _batch64(1, 16, 16))
    with pytest.raises(ValueError, match="data groups"):
        TR.shard_train_step(step, PM.make_mesh((2, 1), devices=[CPU] * 2))(
            st, imgs, masks)


# ---------------------------------------------------------------------------
# float32 against the JAX package's row-split step (GSPMD)
# ---------------------------------------------------------------------------

B, HW, LR = 2, 64, 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_split_step():
    """JAX's `shard_train_step` over a (1, 2) mesh of two virtual CPU
    devices at 2 x 64 x 64: its loss, stepped state and gradients (Adam's
    first moment after one step is 0.1 of the gradient), and the port's
    module and state from the same Flax variables."""
    jm = JU.U2NET(small=True)
    tx, js = JT.create_train_state(jm, jax.random.PRNGKey(0),
                                   input_hw=(HW, HW))
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:HW, 0:HW]
    masks = np.stack([(yy - HW * 0.4 - i) ** 2 + (xx - HW * 0.5 + i) ** 2
                      < (HW * 0.3) ** 2 for i in range(B)]).astype(np.float32)
    mesh = JM.make_mesh((1, 2), devices=jax.devices()[:2])
    with mesh:
        stepped, loss = JT.shard_train_step(JT.make_train_step(jm, tx),
                                            mesh)(js, jnp.asarray(imgs),
                                                  jnp.asarray(masks))
        loss = float(loss)
    variables = _np({"params": js.params, "batch_stats": js.batch_stats})
    tm = U.U2NET(small=True)
    tm.load_state_dict(state_from_flax(variables))
    grads = state_from_flax({"params": _np(jax.tree_util.tree_map(
        lambda m: m / 0.1, stepped.opt_state[0].mu))})
    return {"imgs": torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
            "masks": torch.from_numpy(masks), "module": tm, "loss": loss,
            "grads": grads, "stepped": state_from_flax(_np(
                {"params": stepped.params,
                 "batch_stats": stepped.batch_stats})),
            "state": TR._state_of(tm, TR.Adam(LR))}


def test_row_split_step_matches_jax(jax_split_step):
    """The port's `shard_train_step` on two CPU slots (1, 2) against
    JAX's on two devices (1, 2), both from the same Flax variables: the
    loss within 1e-4 relative; each gradient within 0.25 relative L2 and
    their median within 0.1 (the conv biases ahead of a BatchNorm within
    1e-4 absolute on both sides); the statistics within 1e-3; the
    parameters within 2 lr, 98 % of them within lr (Adam's first step is
    about lr * sign(g); tests/test_torch_train.py says why). Measured:
    loss 5.0e-06, gradients 0.015 median and 0.038 worst, statistics
    3.2e-05, 99.5 % of the parameters within lr."""
    r = jax_split_step
    mesh = PM.make_mesh((1, 2), devices=[CPU] * 2)
    new, loss = TR.shard_train_step(
        TR.make_train_step(r["module"], TR.Adam(LR)), mesh)(
            r["state"], r["imgs"], r["masks"])
    assert abs(float(loss) - r["loss"]) <= 1e-4 * abs(r["loss"])
    rel = []
    for k, m in new.opt_state["mu"].items():
        g, ref = (m / 0.1).numpy(), r["grads"][k].numpy()
        if k.endswith("conv_s1.bias"):
            assert np.abs(g).max() <= 1e-4 and np.abs(ref).max() <= 1e-4, k
            continue
        rel.append(float(np.linalg.norm(g - ref) / np.linalg.norm(ref)))
        assert rel[-1] <= 0.25, (k, rel[-1])
    assert np.median(rel) <= 0.1
    near = []
    for k, p in new.params.items():
        d = np.abs(p.numpy() - r["stepped"][k].numpy())
        assert d.max() <= 2 * LR + 1e-6, k
        near.append(d <= LR + 1e-6)
    assert np.concatenate([n.ravel() for n in near]).mean() >= 0.98
    for k, v in new.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), r["stepped"][k].numpy(),
                                   atol=1e-3, rtol=0, err_msg=k)
