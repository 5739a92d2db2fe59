"""The single-device U^2-Netp training step of the PyTorch port against the
JAX package's (pipeline/train.py), on the CPU.

Both start from the same weights: JAX `create_train_state`'s Flax
variables carried over by models/convert.state_from_flax. The step is the
sum of BCE over d0..d6 with the BatchNorms in train mode (Flax's fast
variance E[y^2] - E[y]^2, momentum 0.9), then one Adam step.

Why the whole network is compared at 64 x 64 and one layer tightly: the
training BatchNorm normalises over (N, H, W), and U^2-Netp's RSU-7 pools
its input five times. At 32 x 32, batch 2, its innermost maps are 1 x 1,
a BatchNorm normalises two numbers, and E[y^2] - E[y]^2 cancels in
float32: the loss of the two packages then differed by 1.1 % and
gradients by orders of magnitude. At 64 x 64 the innermost sets hold 8
numbers; the loss agrees to 1.1e-5 relative, but gradients still pass
through tiny BatchNorm sets: against a float64 run of the port, JAX's
float32 gradients are off by 4 % (median over tensors, 11 % the worst)
and the port's by 1 % (3 %). So one REBNCONV (conv + train BatchNorm +
ReLU) is held tightly on a well-conditioned input, and the network within
the spread its float32 arithmetic has.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from image_segmenter_tpu.models import u2net as JU
from image_segmenter_tpu.pipeline import train as JT
from image_segmenter_tpu_torch.models import u2net as TU
from image_segmenter_tpu_torch.models.convert import state_from_flax
from image_segmenter_tpu_torch.pipeline import train as TT

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

B, HW = 2, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous()


def _batch(b=B, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    masks = np.stack([(yy - hw * 0.4 - i) ** 2 + (xx - hw * 0.5 + i) ** 2
                      < (hw * 0.3) ** 2 for i in range(b)]).astype(np.float32)
    return imgs, masks


def _port_loss_grads(module, state, imgs, masks):
    loss, grads, stats = TT.loss_and_grads(module, state, _nchw(imgs),
                                           torch.from_numpy(masks))
    return float(loss), grads, stats


@pytest.fixture(scope="module")
def one_step():
    """JAX's loss, gradients, new statistics and stepped state; the port's
    module and state from the same variables."""
    jm = JU.U2NET(small=True)
    tx, js = JT.create_train_state(jm, jax.random.PRNGKey(0),
                                   input_hw=(HW, HW))
    imgs, masks = _batch()

    def loss_fn(params, stats):
        outs, mut = jm.apply({"params": params, "batch_stats": stats}, imgs,
                             train=True, mutable=["batch_stats"])
        return sum(JT._bce(d, masks[..., None]) for d in outs), \
            mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        js.params, js.batch_stats)
    stepped, step_loss = jax.jit(JT.make_train_step(jm, tx))(js, imgs, masks)
    variables = _np({"params": js.params, "batch_stats": js.batch_stats})
    tm = TU.U2NET(small=True)
    tm.load_state_dict(state_from_flax(variables))
    return {
        "imgs": imgs, "masks": masks, "module": tm, "loss": float(loss),
        "grads": state_from_flax({"params": _np(grads)}),
        "stats": state_from_flax({"params": {}, "batch_stats": _np(stats)}),
        "stepped": state_from_flax(_np({"params": stepped.params,
                                        "batch_stats": stepped.batch_stats})),
        "step_loss": float(step_loss),
        "state": TT._state_of(tm, TT.Adam(1e-3)),
    }


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_loss_matches_jax(one_step):
    """The summed BCE of d0..d6 in train mode: within 1e-4 relative
    (measured 1.1e-5: float32 sums in another order)."""
    loss, _, _ = _port_loss_grads(one_step["module"], one_step["state"],
                                  one_step["imgs"], one_step["masks"])
    assert abs(loss - one_step["loss"]) <= 1e-4 * abs(one_step["loss"])


def test_gradients_match_jax(one_step):
    """Every parameter's gradient, relative L2 against JAX's: at most 0.25
    for each tensor and 0.1 for the median (measured 0.087 and 0.039; JAX's
    own float32 gradients are 0.11 and 0.040 from float64, see the module
    docstring). The REBNCONV conv biases feed a train BatchNorm, which
    removes any constant: their gradient is 0 in exact arithmetic, so they
    are held to an absolute 1e-4 on both sides (measured 6.7e-6 here and
    1.4e-5 in JAX, against weight gradients of norm 0.139 and more)."""
    _, grads, _ = _port_loss_grads(one_step["module"], one_step["state"],
                                   one_step["imgs"], one_step["masks"])
    ref = one_step["grads"]
    assert set(grads) == set(ref)
    rel = []
    for k, g in grads.items():
        g, r = g.numpy(), ref[k].numpy()
        assert g.shape == r.shape
        if k.endswith("conv_s1.bias"):
            assert np.abs(g).max() <= 1e-4 and np.abs(r).max() <= 1e-4, k
            continue
        rel.append(_rel_l2(g, r))
        assert rel[-1] <= 0.25, (k, rel[-1])
    assert np.median(rel) <= 0.1


def test_batch_stats_match_jax(one_step):
    """The running means and variances after one step (0.9 of the old,
    0.1 of the batch's biased statistics): within 1e-3 absolute (measured
    5e-5), every BatchNorm of the network."""
    _, _, stats = _port_loss_grads(one_step["module"], one_step["state"],
                                   one_step["imgs"], one_step["masks"])
    ref = one_step["stats"]
    assert set(stats) == set(ref)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-3,
                                   rtol=0, err_msg=k)


def test_train_step_matches_jax(one_step):
    """`make_train_step` end to end. Its parameters are its state's plus
    Adam's update of its own gradients, bit for bit. Against JAX's step:
    the loss within 1e-4 relative, the statistics within 1e-3, and the
    parameters within 2 lr. Adam's first step moves a parameter by about
    lr * sign(g), so a gradient whose sign differs between the packages
    (small components of gradients that agree to 4 % in L2, see
    `test_gradients_match_jax`) moves it by up to 2 lr; the optimizer
    alone is held to optax in `test_adam_matches_optax`. At least 98 % of
    the parameters are within lr of JAX's (measured 98.9 %)."""
    tx = TT.Adam(1e-3)
    step = TT.make_train_step(one_step["module"], tx)
    state = one_step["state"]
    new, loss = step(state, _nchw(one_step["imgs"]),
                     torch.from_numpy(one_step["masks"]))
    assert new.step == 1 and new.opt_state["count"] == 1
    _, grads, _ = _port_loss_grads(one_step["module"], state,
                                   one_step["imgs"], one_step["masks"])
    updates, _ = tx.update(grads, state.opt_state)
    for k, p in new.params.items():
        assert torch.equal(p, state.params[k] + updates[k]), k
    assert abs(float(loss) - one_step["step_loss"]) \
        <= 1e-4 * one_step["step_loss"]
    ref = one_step["stepped"]
    near = []
    for k, p in new.params.items():
        d = np.abs(p.numpy() - ref[k].numpy())
        assert d.max() <= 2e-3 + 1e-6, k
        near.append(d <= 1e-3 + 1e-6)
    assert np.concatenate([n.ravel() for n in near]).mean() >= 0.98
    for k, v in new.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-3,
                                   rtol=0, err_msg=k)


def test_step_leaves_its_input_state_alone(one_step):
    """The step is a function of the state: the state it was given, and
    the module's own parameters and buffers, are unchanged."""
    state = one_step["state"]
    before = {k: v.clone() for k, v in
              {**state.params, **state.batch_stats}.items()}
    own = {k: v.clone() for k, v in one_step["module"].state_dict().items()}
    TT.make_train_step(one_step["module"], TT.Adam())(
        state, _nchw(one_step["imgs"]), torch.from_numpy(one_step["masks"]))
    for k, v in {**state.params, **state.batch_stats}.items():
        assert torch.equal(v, before[k]), k
    for k, v in one_step["module"].state_dict().items():
        assert torch.equal(v, own[k]), k


@pytest.mark.parametrize("dirate,half", [(1, False), (2, False), (1, True)])
def test_rebnconv_train_matches_flax(dirate, half):
    """One REBNCONV in train mode on a well-conditioned input (16 x 16,
    batch 2, 512 numbers a BatchNorm): the output, the gradients of a
    random projection of it, and the new statistics within 1e-4 relative
    (float32 sums in another order) at float32; at half=True the
    convolution runs in bfloat16 on both sides and rounds by library, so
    the output is held to 2e-2 of its scale and the statistics to 1e-2."""
    rng = np.random.default_rng(dirate)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    proj = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    jm = JU.REBNCONV(8, dirate, half)
    v = jm.init(jax.random.PRNGKey(dirate), jnp.zeros((1, 16, 16, 4)))
    v = {"params": v["params"], "batch_stats": {
        "bn": {"mean": jnp.full((8,), 0.3), "var": jnp.full((8,), 2.0)}}}

    def f(params):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          x, train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * proj), (y, mut["batch_stats"])

    (jl, (jy, jstats)), jg = jax.value_and_grad(f, has_aux=True)(v["params"])
    tm = TU.REBNCONV(4, 8, dirate, half)
    state = state_from_flax(_np(v))
    tm.load_state_dict(state)
    y = tm(_nchw(x), train=True)
    tl = (y.to(torch.float32) * _nchw(proj)).sum()
    tl.backward()
    tol = 2e-2 if half else 1e-4
    jy = np.asarray(jy, np.float32)
    got = y.to(torch.float32).permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(got - jy).max() <= tol * np.abs(jy).max()
    jstats = state_from_flax({"params": {}, "batch_stats": _np(jstats)})
    for k, val in jstats.items():
        np.testing.assert_allclose(
            dict(tm.named_buffers())[k].numpy(), val,
            rtol=1e-2 if half else 1e-5, atol=1e-2 if half else 1e-6)
    if half:
        return
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    jgs = state_from_flax({"params": _np(jg)})
    for name, p in tm.named_parameters():
        if name == "conv_s1.bias":  # 0 in exact arithmetic (BatchNorm)
            assert p.grad.abs().max() <= 1e-3 and jgs[name].abs().max() <= 1e-3
            continue
        assert _rel_l2(p.grad.numpy(), jgs[name].numpy()) <= 1e-4, name


def test_adam_matches_optax():
    """The written-out Adam against optax.adam(1e-3) on the same
    parameters and gradients for 3 steps, with near-zero gradients of
    either sign among them: parameters within 1e-7 absolute (a float32 ulp
    of these values is 6e-8 to 1.2e-7) and the moments within 1e-6
    relative."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4, 3, 3), "b": (17,), "c": (2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp, jo = params, tx.init(params)
    ours = TT.Adam(1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = ours.init(tp)
    for g in grads:
        upd, jo = tx.update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
        tu, to = ours.update({k: torch.from_numpy(v) for k, v in g.items()},
                             to)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=0)
            np.testing.assert_allclose(to["mu"][k].numpy(),
                                       np.asarray(jo[0].mu[k]), rtol=1e-6)
            np.testing.assert_allclose(to["nu"][k].numpy(),
                                       np.asarray(jo[0].nu[k]), rtol=1e-6)
    assert to["count"] == int(jo[0].count) == 3


def test_bce_matches_jax():
    """_bce: clip to [1e-7, 1 - 1e-7], the mean; within 1e-6 relative,
    also at predictions of exactly 0 and 1."""
    rng = np.random.default_rng(2)
    p = rng.random((2, 9, 9, 1)).astype(np.float32)
    p[0, 0, 0, 0], p[0, 0, 1, 0] = 0.0, 1.0
    t = (rng.random((2, 9, 9, 1)) > 0.5).astype(np.float32)
    ref = float(JT._bce(jnp.asarray(p), jnp.asarray(t)))
    got = float(TT._bce(torch.from_numpy(p), torch.from_numpy(t)))
    assert np.isfinite(got) and abs(got - ref) <= 1e-6 * abs(ref)


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint / restore_checkpoint: every tensor bit-equal, the
    step and Adam's count kept, and the restored state steps exactly as
    the uninterrupted one on the CPU; a template with other names is
    refused."""
    tm = TU.U2NET(small=True)
    tx, state = TT.create_train_state(tm, seed=3, input_hw=(32, 32))
    imgs, masks = _batch(2, 32, seed=4)
    step = TT.make_train_step(tm, tx)
    state, _ = step(state, _nchw(imgs), torch.from_numpy(masks))
    path = os.path.join(tmp_path, "state.pt")
    TT.save_checkpoint(path, state)
    _, fresh = TT.create_train_state(TU.U2NET(small=True), seed=9)
    restored = TT.restore_checkpoint(path, fresh)
    assert restored.step == state.step == 1
    assert restored.opt_state["count"] == 1
    for part in ("params", "batch_stats"):
        for k, v in getattr(state, part).items():
            assert torch.equal(getattr(restored, part)[k], v), k
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            assert torch.equal(restored.opt_state[m][k], v), k
    a, la = step(state, _nchw(imgs), torch.from_numpy(masks))
    b, lb = step(restored, _nchw(imgs), torch.from_numpy(masks))
    assert torch.equal(la, lb)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    bad = fresh._replace(params={"x": torch.zeros(1)})
    with pytest.raises(ValueError):
        TT.restore_checkpoint(path, bad)


def test_create_train_state_is_seeded():
    """The same seed gives the same weights (one explicit CPU generator,
    models/registry._seeded_init), another seed others; Adam starts at
    zero moments and count 0, the step at 0."""
    a = TT.create_train_state(TU.U2NET(small=True), seed=1)[1]
    b = TT.create_train_state(TU.U2NET(small=True), seed=1)[1]
    c = TT.create_train_state(TU.U2NET(small=True), seed=2)[1]
    k = "stage1.rebnconvin.conv_s1.weight"
    assert torch.equal(a.params[k], b.params[k])
    assert not torch.equal(a.params[k], c.params[k])
    assert a.step == 0 and a.opt_state["count"] == 0
    assert all(not v.any() for v in a.opt_state["mu"].values())
    assert set(a.batch_stats) == {
        n for n, _ in TU.U2NET(small=True).named_buffers()
        if n.endswith(("running_mean", "running_var"))}


def _rebnconv_before_train_mode(self, x, train=False):
    """REBNCONV.forward as it was before the train argument (inference
    BatchNorm from the running buffers, float32, Flax's order)."""
    conv, bn = self.conv_s1, self.bn_s1
    y = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None,
                 padding=conv.padding, dilation=conv.dilation)
    y = y + conv.bias.to(self.dtype)[:, None, None]
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (y.to(torch.float32) - bn.running_mean[:, None, None]) \
        * mul[:, None, None] + bn.bias[:, None, None]
    return torch.relu(y).to(self.dtype)


@pytest.mark.parametrize("half", [False, True])
def test_inference_keeps_its_bits(monkeypatch, half):
    """train=False (the default) gives the bits of the forward before the
    train branch was added, at float32 and bfloat16, whatever
    nn.Module.training says; and moves no running buffer."""
    tm = TU.U2NET(small=True, half=half)
    TT.create_train_state(tm, seed=0)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    x = _nchw(_batch(1, 48, seed=6)[0])
    bufs = {k: v.clone() for k, v in tm.named_buffers()}
    with torch.no_grad():
        tm.train()
        new = tm(x)
        tm.eval()
        new_eval = tm(x, train=False)
        monkeypatch.setattr(TU.REBNCONV, "forward",
                            _rebnconv_before_train_mode)
        old = tm(x)
    for a, b, c in zip(new, new_eval, old):
        assert torch.equal(a, c) and torch.equal(b, c)
    for k, v in tm.named_buffers():
        assert torch.equal(v, bufs[k]), k
