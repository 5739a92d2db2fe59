"""SAM's encoder attention (kernels/sam_attention.py) on the CPU: the plain
version, which the CUDA kernel is held to on the card, against the
float32 formula of models/sam.Attention (the bias materialised as
rel_h[..., None] + rel_w[..., None, :], then softmax times v), on inputs
made as the model makes them: q, k and v strided views of one qkv
projection, rel_h and rel_w from the model's two einsums.

The kernel itself has no CPU mode; tests/test_torch_cuda.py holds it to
the plain version on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import sam_attention as SA
from image_segmenter_tpu_torch.models import sam as S
from image_segmenter_tpu_torch.utils.profiling import replayed_counters

torch.set_num_threads(2)

# float32 on both sides, the same products in another grouping (the scale
# applied after q k^T, the softmax's division after the product with v)
F32_TOL = 1e-5


def _operands(b, nh, h, w, d, seed=0, dtype=torch.float32, x=None):
    """q, k, v as (b, nh, h w, d) views of a (b, h w, 3 nh d) projection,
    rel_h and rel_w from the model's einsums on random tables, the scale;
    `x` (b, h, w, 3 nh d) replaces the random projection."""
    g = torch.Generator().manual_seed(seed)
    if x is None:
        x = torch.randn(b, h, w, 3 * nh * d, generator=g)
    qkv = x.to(dtype).reshape(b, h * w, 3, nh, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.unbind(0)
    rh = (0.1 * torch.randn(h, h, d, generator=g)).to(dtype)
    rw = (0.1 * torch.randn(w, w, d, generator=g)).to(dtype)
    r_q = q.reshape(b * nh, h, w, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    return q, k, v, rel_h, rel_w, d ** -0.5


def _formula(q, k, v, rel_h, rel_w, scale):
    """models/sam.Attention's float32 path, (b, h w, nh d)."""
    b, nh, n, d = q.shape
    _, h, w, _ = rel_h.shape
    q, k, v = (t.float().reshape(b * nh, n, d) for t in (q, k, v))
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = (attn.view(b * nh, h, w, h, w) + rel_h.float()[:, :, :, :, None]
            + rel_w.float()[:, :, :, None, :]).view(b * nh, n, n)
    x = attn.softmax(dim=-1) @ v
    return x.view(b, nh, n, d).permute(0, 2, 1, 3).reshape(b, n, nh * d)


def _err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


GRIDS = {"window": (3, 14, 14), "global": (1, 64, 64), "ragged": (2, 8, 12)}


@pytest.mark.parametrize("d", [16, 64, 80])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_matches_the_float32_formula(grid, d):
    """ViT-H's 14 x 14 windows and 64 x 64 global grid and a grid that is
    not square, at the test config's, ViT-B's and ViT-H's head dims."""
    b, h, w = GRIDS[grid]
    ops = _operands(b, 2, h, w, d, seed=d)
    got = SA.attention(*ops)
    assert got.shape == (b, h * w, 2 * d) and got.dtype == torch.float32
    assert _err(got, _formula(*ops)) <= F32_TOL


def test_plain_reads_strided_views_of_the_projection_with_padded_windows():
    """The model's windowed block: a 10 x 10 grid zero-padded to 12 x 12
    and cut into 4 x 4 windows (the padded tokens attend and are attended
    like any other), through a projection with a bias, so that padded
    tokens have q, k and v of their own. The views give the bytes of
    their contiguous copies, in float32 and in bfloat16."""
    g = torch.Generator().manual_seed(5)
    nh, d = 2, 16
    x = torch.randn(2, 10, 10, nh * d, generator=g)
    win, pad_hw = S.window_partition(x, 4)
    assert pad_hw == (12, 12) and win.shape == (18, 4, 4, nh * d)
    assert float(win[-1, -1, -1].abs().max()) == 0.0
    wq = torch.randn(3 * nh * d, nh * d, generator=g) * nh ** -0.5 / 4
    proj = F.linear(win, wq, torch.randn(3 * nh * d, generator=g))
    for dtype in (torch.float32, torch.bfloat16):
        ops = _operands(18, nh, 4, 4, d, seed=7, dtype=dtype, x=proj)
        q, k, v = ops[:3]
        assert not q.is_contiguous() and q.stride(-1) == 1
        got = SA.attention(*ops)
        assert torch.equal(got, SA.attention(q.contiguous(), k.contiguous(),
                                             v.contiguous(), *ops[3:]))
        if dtype == torch.float32:
            assert _err(got, _formula(*ops)) <= F32_TOL


@pytest.mark.parametrize("drop", ["both", "rel_h", "rel_w"])
def test_a_dropped_bias_fails_the_comparison(drop):
    """The tables moved the output by far more than the tolerance: a plain
    version that left either term out would not pass."""
    ops = list(_operands(3, 2, 14, 14, 16, seed=2))
    ref = _formula(*ops)
    if drop in ("both", "rel_h"):
        ops[3] = torch.zeros_like(ops[3])
    if drop in ("both", "rel_w"):
        ops[4] = torch.zeros_like(ops[4])
    assert _err(SA.attention(*ops), ref) > 1000 * F32_TOL


def test_bf16_rounds_the_bias_and_the_probabilities():
    """In bfloat16 the plain version rounds the bias, P and the output:
    against the float32 formula on the same (bfloat16) operands it moves
    by far more than float32's rounding, and by no more than those three
    roundings can, each at most 2^-9 relative: the output's 2^-9 max|o|,
    P's 2^-9 max|v|, the bias's a score shift of 2^-9 max|bias|, which
    moves each weight by twice that relative, so 2^-8 max|bias| max|v|."""
    ops = _operands(2, 2, 14, 14, 80, seed=4, dtype=torch.bfloat16)
    got = SA.attention(*ops)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 196, 160)
    ref = _formula(*ops)
    v_max = float(ops[2].float().abs().max())
    b_max = float((ops[3].float()[..., :, None]
                   + ops[4].float()[..., None, :]).abs().max())
    bound = 2 ** -9 * float(ref.abs().max()) + 2 ** -9 * v_max \
        + 2 ** -8 * b_max * v_max
    err = float((got.float() - ref).abs().max())
    assert 100 * F32_TOL * float(ref.abs().max()) < err <= bound


def _bad_operands(what):
    ops = list(_operands(2, 2, 4, 4, 16, dtype=torch.bfloat16))[:5]
    if what == "float32":
        return [t.float() for t in ops]
    if what == "head dim":
        return list(_operands(2, 2, 4, 4, 40, dtype=torch.bfloat16))[:5]
    if what == "too wide":
        return list(_operands(1, 1, 2, 2, 144, dtype=torch.bfloat16))[:5]
    if what == "last stride":
        return [ops[0].transpose(2, 3).contiguous().transpose(2, 3),
                *ops[1:]]
    if what == "grid":
        return [*ops[:3], ops[3][:, :2], ops[4][:, :2]]
    return [*ops[:3], ops[3][:2], ops[4][:2]]  # "heads"


def test_the_wrapper_takes_the_models_views():
    ops = _operands(2, 2, 4, 4, 16, dtype=torch.bfloat16)
    assert SA._check(*ops[:5]) == (2, 2, 4, 4, 16)


@pytest.mark.parametrize("what", ["float32", "head dim", "too wide",
                                  "last stride", "grid", "heads"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what):
    """`_check` runs before any launch: another type, head dim, layout or
    grid raises."""
    with pytest.raises(ValueError):
        SA._check(*_bad_operands(what))


def test_the_bf16_block_calls_the_kernel_once_and_no_sdpa(monkeypatch):
    """A bfloat16 encoder runs each block's attention through
    `sam_attention.attention`, once a block, and never through
    F.scaled_dot_product_attention; the float32 encoder through neither.
    The replays of a compiled run carry the kernel's launch counter."""
    calls = []
    real = SA.attention

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("the encoder called F.scaled_dot_product_"
                             "attention")

    monkeypatch.setattr(SA, "attention", spy)
    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    cfg = S.SamConfig(embed_dim=32, depth=4, num_heads=2,
                      global_attn_indexes=(1, 3), window_size=4,
                      patch_size=16, img_size=160, prompt_dim=32)
    for half in (True, False):
        m = S.Sam(cfg, half=half)
        S.seeded_init(m, torch.Generator().manual_seed(1))
        calls.clear()
        with torch.no_grad():
            m.image_encoder(torch.randn(1, 3, 160, 160),
                            torch.bfloat16 if half else torch.float32)
        assert calls == ([(9, 2, 16, 16), (1, 2, 100, 16)] * 2
                         if half else [])
    assert (SA, "LAUNCHES") in replayed_counters()
