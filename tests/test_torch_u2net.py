"""U^2-Net in the PyTorch port against the JAX package's Flax modules.

Both packages compute the same network from the same weights: the JAX
package's seeded Flax variables, carried over by models/convert.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.models import u2net as JU
from image_segmenter_tpu_torch.models import registry as TR
from image_segmenter_tpu_torch.models import u2net as TU
from image_segmenter_tpu_torch.models.convert import state_from_flax

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)


def _pair(small: bool, half: bool, seed: int = 0):
    jm = JU.U2NET(small=small, half=half)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    tm = TU.U2NET(small=small, half=half).eval()
    tm.load_state_dict(state_from_flax(jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm


def _forward_both(small, half, hw, seed=0):
    jm, v, tm = _pair(small, half, seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jo = [np.asarray(o) for o in jax.jit(jm.apply)(v, x)]
    with torch.no_grad():
        to = [o.permute(0, 2, 3, 1).numpy()
              for o in tm(torch.from_numpy(x).permute(0, 3, 1, 2))]
    return jo, to


def test_state_from_flax_covers_every_weight():
    """Every port parameter and buffer is set from a Flax leaf (strict load),
    with HWIO -> OIHW kernels."""
    jm, v, tm = _pair(small=True, half=False)
    state = state_from_flax(jax.tree_util.tree_map(np.asarray, v))
    k = np.asarray(v["params"]["stage1"]["rebnconvin"]["conv"]["kernel"])
    np.testing.assert_array_equal(
        state["stage1.rebnconvin.conv_s1.weight"].numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    n_flax = len(jax.tree_util.tree_leaves(v))
    assert len(state) == n_flax
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(v["params"]))


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_u2netp_f32_matches_flax(hw):
    """float32: convolution sums in another order only -> the seven sigmoid
    outputs agree to 1e-4 absolute."""
    jo, to = _forward_both(small=True, half=False, hw=hw)
    assert len(jo) == len(to) == 7
    for a, b in zip(jo, to):
        assert a.shape == b.shape == (2, *hw, 1)
        assert np.abs(a - b).max() < 1e-4


def test_u2netp_half_matches_flax():
    """bfloat16 convolutions (half=True): one bf16 rounding flips where the
    two libraries' f32 accumulations straddle a rounding boundary, and the
    flips compound through ~60 layers. Measured about 2e-3 on the sigmoid
    outputs; the bound is 1e-2 (a u8 step is 3.9e-3)."""
    jo, to = _forward_both(small=True, half=True, hw=(64, 64))
    for a, b in zip(jo, to):
        assert np.abs(a - b).max() < 1e-2


def test_u2net_full_f32_matches_flax():
    """The full U^2-Net (mid up to 256, out up to 512) at a small input."""
    jo, to = _forward_both(small=False, half=False, hw=(32, 32), seed=1)
    for a, b in zip(jo, to):
        assert np.abs(a - b).max() < 1e-4


def test_session_seeded_init_is_deterministic():
    """Seeded weights: same seed -> same weights, Flax-like statistics."""
    a = TR.Session("u2netp", device="cpu", seed=3)
    b = TR.Session("u2netp", device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.module.stage1.rebnconvin.conv_s1.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.15
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    # ISNet: the same seeded init covers its conv_in
    c = TR.Session("isnet-general-use", device="cpu", seed=3)
    d = TR.Session("isnet-general-use", device="cpu", seed=3)
    assert not c.weights_loaded
    for (ka, va), (kb, vb) in zip(c.module.state_dict().items(),
                                  d.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = c.module.conv_in.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.15
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    assert not c.module.conv_in.bias.any()
