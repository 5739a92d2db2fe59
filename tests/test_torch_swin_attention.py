"""BiRefNet's window attention (kernels/swin_attention.py) on the CPU.

The plain version, which the CUDA kernel is held to on the card, against
the block's path before the kernel (pad the normalised grid with zeros,
roll, partition, qkv, SDPA with the materialised mask, reverse, roll
back, crop; copied below), and against float64 loops that index the
grid as the kernel does; a Python twin of the kernel's bias lookup (its
packed table pairs, per-thread key offsets and mask bits) against the
gathered table plus the shift mask; the wrapper's refusals; the model's
blocks calling the attention once a block.

The kernel itself has no CPU mode; tests/test_torch_cuda.py holds it to
the plain version on the card.
"""

import itertools
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import swin_attention as KSW
from image_segmenter_tpu_torch.models import birefnet as B
from image_segmenter_tpu_torch.utils.profiling import replayed_counters

torch.set_num_threads(2)

WS = 12
# (H, W) of a block's grid: a multiple of 12 (no pad), two that pad, one
# smaller than a window (one window, all four roll regions at shift 6)
GRIDS = [(24, 24), (20, 30), (13, 25), (3, 5)]


def _attn(heads=2, d=32, seed=0, half=False):
    """A WindowAttention with a N(0, 1) table (as seeded_init draws it)
    and a nonzero qkv bias, so that pad tokens have q, k and v of their
    own; its bfloat16 copies when `half`."""
    g = torch.Generator().manual_seed(seed)
    m = B.WindowAttention(heads * d, WS, heads)
    with torch.no_grad():
        m.relative_position_bias_table.normal_(generator=g)
        for lin in (m.qkv, m.proj):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                             * lin.in_features ** -0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g))
            lin.weight_low = lin.weight.to(torch.bfloat16) if half else None
            lin.bias_low = lin.bias.to(torch.bfloat16) if half else None
    return m


def _grid(b, h, w, c, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, h, w, c, generator=g).to(dtype)


def _parent_attention(attn, y, shift):
    """The block's window attention before the kernel, its output before
    `proj` at each token's own position: y padded with zeros to multiples
    of 12, rolled, cut into windows, through qkv, SDPA with the mask (a
    frame at a time in a shifted block), reversed, rolled back, cropped."""
    b, h, w, c = y.shape
    hp, wp = -(-h // WS) * WS, -(-w // WS) * WS
    if hp > h or wp > w:
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    x = KSW.window_partition(y, WS)
    bw, n, _ = x.shape
    nh = attn.num_heads
    q, k, v = attn.qkv(x).reshape(bw, n, 3, nh, c // nh) \
        .permute(2, 0, 3, 1, 4).unbind(0)
    mask = attn.mask(hp, wp, shift, x.dtype, x.device)
    nw = mask.shape[0]
    if nw == 1:
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=attn.scale)
    else:
        o = torch.cat([F.scaled_dot_product_attention(
            q[i * nw:(i + 1) * nw], k[i * nw:(i + 1) * nw],
            v[i * nw:(i + 1) * nw], attn_mask=mask, scale=attn.scale)
            for i in range(b)])
    o = KSW.window_reverse(o.transpose(1, 2).reshape(bw, n, c), WS, b, hp,
                           wp)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o[:, :h, :w]


def _plain(attn, y, shift):
    """The plain version on the projection of y's unpadded grid, as
    WindowAttention.forward hands it over."""
    h, w = y.shape[1:3]
    lin = attn.qkv
    bias = lin.bias_low if y.dtype == torch.bfloat16 else lin.bias
    mask = attn.mask(-(-h // WS) * WS, -(-w // WS) * WS, shift, y.dtype,
                     y.device)
    return KSW.attention(lin(y), bias, attn.relative_position_bias_table,
                         shift, attn.scale, mask=mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("grid", GRIDS)
def test_plain_matches_the_parent_path(grid, shift, dtype):
    """The projection first, pad rows from its bias: the parent path's
    output bit for bit in float32, within one bfloat16 unit in bfloat16
    (2^-7 of each value: the same SDPA on q, k and v from the same
    rows); and so the block's output after `proj`. Two frames; on the
    CPU nothing is launched."""
    h, w = grid
    half = dtype == torch.bfloat16
    attn = _attn(seed=h + shift, half=half)
    y = _grid(2, h, w, 64, seed=w, dtype=dtype)
    n0 = KSW.LAUNCHES
    with torch.no_grad():
        got = _plain(attn, y, shift)
        want = _parent_attention(attn, y, shift)
        block = attn(y, shift)
    assert KSW.LAUNCHES == n0
    assert got.shape == (2, h, w, 64) and got.dtype == dtype
    if half:
        assert bool(((got.float() - want.float()).abs()
                     <= 2 ** -7 * want.float().abs()).all())
    else:
        assert torch.equal(got, want)
        assert torch.equal(block, attn.proj(want))


def _regions(r, hp, shift):
    """The roll's region of rolled row (or column) r: against hp - 12 and
    hp - shift."""
    return np.where(r < hp - WS, 0, np.where(r < hp - shift, 1, 2))


def _loops(qkv, bias, table, shift, scale):
    """Window attention in float64, window by window, indexed as the kernel
    indexes the grid: window token (y, x) of window (wy, wx) at rolled
    position (r, c) = (12 wy + y, 12 wx + x) reads ((r + s) mod Hp,
    (c + s) mod Wp), or `bias` where that lies at or past H or W; score
    q.k * scale + table[(yi - yj + 11) 23 + xi - xj + 11] - 100 where a
    shifted block's regions differ; each real query's output at its own
    position."""
    qkv, bias, table = (np.asarray(t, np.float64) for t in (qkv, bias,
                                                             table))
    b, h, w, c3 = qkv.shape
    c, nh = c3 // 3, table.shape[1]
    d = c // nh
    hp, wp = -(-h // WS) * WS, -(-w // WS) * WS
    yy, xx = np.divmod(np.arange(WS * WS), WS)
    idx = (yy[:, None] - yy[None] + WS - 1) * (2 * WS - 1) \
        + xx[:, None] - xx[None] + WS - 1
    out = np.full((b, h, w, c), np.nan)
    for f, wy, wx in itertools.product(range(b), range(hp // WS),
                                       range(wp // WS)):
        r, cc = wy * WS + yy, wx * WS + xx
        sr, sc = (r + shift) % hp, (cc + shift) % wp
        real = (sr < h) & (sc < w)
        rows = np.where(real[:, None], qkv[f, np.minimum(sr, h - 1),
                                           np.minimum(sc, w - 1)], bias)
        m = np.zeros((WS * WS, WS * WS))
        if shift:
            rr, cr = _regions(r, hp, shift), _regions(cc, wp, shift)
            m[(rr[:, None] != rr[None]) | (cr[:, None] != cr[None])] = -100.0
        for hd in range(nh):
            q, k, v = (rows[:, i * c + hd * d:i * c + (hd + 1) * d]
                       for i in range(3))
            s = q @ k.T * scale + table[idx, hd] + m
            p = np.exp(s - s.max(1, keepdims=True))
            o = (p / p.sum(1, keepdims=True)) @ v
            out[f, sr[real], sc[real], hd * d:(hd + 1) * d] = o[real]
    return out


@pytest.mark.parametrize("grid,shift", [((13, 25), 6), ((20, 30), 0),
                                        ((3, 5), 6), ((24, 24), 6)])
def test_plain_indexes_the_grid_as_the_kernel_does(grid, shift):
    """float32 against the float64 loops, within float32's rounding; pad
    keys carry the projection's bias as k and v: the same loops with zero
    pad rows lie far off wherever the grid pads."""
    h, w = grid
    attn = _attn(heads=2, d=8, seed=3)
    g = torch.Generator().manual_seed(h * w)
    qkv = torch.randn(2, h, w, 48, generator=g)
    bias = attn.qkv.bias.detach()
    table = attn.relative_position_bias_table.detach()
    mask = attn.mask(-(-h // WS) * WS, -(-w // WS) * WS, shift,
                     torch.float32, "cpu")
    got = KSW.attention_plain(qkv, bias, mask, shift, attn.scale).double()
    want = _loops(qkv, bias, table, shift, attn.scale)
    assert not np.isnan(want).any()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if h % WS or w % WS:
        zeros = _loops(qkv, 0 * bias, table, shift, attn.scale)
        assert np.abs(got.numpy() - zeros).max() > 1e-2


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _cu_constant(name: str) -> int:
    src = (_build.CSRC / "swin_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_the_kernels_constants_are_the_wrappers():
    assert _cu_constant("kWs") == KSW.WINDOW == WS
    assert _cu_constant("kD") == KSW.HEAD_DIM
    # three warps of 16-query tiles cover a window's 144 queries
    assert 16 * _cu_constant("kWarps") * 3 == WS * WS


@pytest.mark.parametrize("shift", [0, 6, 4])
def test_the_kernels_bias_lookup_is_the_gathered_table_and_mask(shift):
    """A twin of the kernel's lookup: table entry k packed as the pair
    (bf16(T[k]), bf16(T[k - 1])), once plain and once plus -100; thread tq's
    key pair jt = 3 m + rho at 24 m + 8 rho + 2 tq, its table row a - kb[rho]
    - 46 m, a = 23 yi + xi + 264; the masked table where bit jt of the
    query's selection is set (krow / kcol, flipped past the cut, in a
    shifted last row / column). For every query, pair and kind of window
    it gives bf16(table + mask) of both keys, as WindowAttention.mask
    rounds it (the shift of 4 tests the cut's generality; an odd one would
    split a pair, and the wrapper refuses it)."""
    t = np.random.default_rng(shift).standard_normal(529).astype(np.float32)
    prev = np.concatenate([[0.0], t[:-1]]).astype(np.float32)
    packed = [np.stack([_bf16(t), _bf16(prev)]),
              np.stack([_bf16(t + np.float32(-100)),
                        _bf16(prev + np.float32(-100))])]
    split = WS - shift
    yy, xx = np.divmod(np.arange(WS * WS), WS)
    idx = (yy[:, None] - yy[None] + 11) * 23 + xx[:, None] - xx[None] + 11
    for last_row, last_col in itertools.product((False, True), repeat=2):
        if not shift and (last_row or last_col):
            continue
        # the window's mask: regions of a last window row / column split
        # at 12 - shift
        ry = np.where(last_row, yy >= split, 0)
        rx = np.where(last_col, xx >= split, 0)
        m = np.where((ry[:, None] != ry[None]) | (rx[:, None] != rx[None]),
                     np.float32(-100), np.float32(0))
        want = _bf16(t[idx] + m)
        for tq in range(4):
            kb, krow, kcol = [], 0, 0
            for rho in range(3):
                c = 8 * rho + 2 * tq
                cy, cx = divmod(c, WS)
                kb.append(23 * cy + cx)
                for mm in range(6):
                    krow |= int(2 * mm + cy >= split) << (3 * mm + rho)
                    kcol |= int(cx >= split) << (3 * mm + rho)
            for i in range(WS * WS):
                yi, xi = divmod(i, WS)
                sel = 0
                if last_row:
                    sel |= ~krow if yi >= split else krow
                if last_col:
                    sel |= ~kcol if xi >= split else kcol
                a = 23 * yi + xi + 264
                for jt in range(18):
                    mm, rho = divmod(jt, 3)
                    k = a - kb[rho] - 46 * mm
                    pair = packed[(sel >> jt) & 1][:, k]
                    j = 8 * jt + 2 * tq
                    assert pair[0] == want[i, j] and pair[1] == want[i, j + 1]


def _operands(what="ok"):
    """bfloat16 qkv (2, 13, 25, 3C) of two heads of 32, its bias, a
    (529, 2) float32 table, shift 6; `what` breaks one."""
    qkv = torch.zeros(2, 13, 25, 192, dtype=torch.bfloat16)
    bias = torch.zeros(192, dtype=torch.bfloat16)
    table = torch.zeros(529, 2)
    shift = 6
    if what == "float32":
        qkv, bias = qkv.float(), bias.float()
    elif what == "float32 bias":
        bias = bias.float()
    elif what == "bf16 table":
        table = table.to(torch.bfloat16)
    elif what == "head dim 24":
        qkv, bias, table = qkv[..., :144], bias[:144], table[:, :2]
    elif what == "last stride":
        qkv = torch.zeros(2, 13, 192, 25, dtype=torch.bfloat16) \
            .transpose(2, 3)
    elif what == "token stride":
        qkv = torch.zeros(2, 13, 25, 196, dtype=torch.bfloat16)[..., :192]
    elif what == "unaligned":
        qkv = torch.zeros(2 * 13 * 25 * 192 + 1, dtype=torch.bfloat16)[1:] \
            .view(2, 13, 25, 192)
    elif what == "table rows":
        table = table[:441]
    elif what == "bias shape":
        bias = bias[:64]
    elif what == "shift":
        shift = 12
    elif what == "odd shift":
        shift = 5
    return qkv, bias, table, shift


def test_the_wrapper_takes_the_models_operands():
    assert KSW._check(*_operands()) == (2, 13, 25, 64, 2)


@pytest.mark.parametrize("what", [
    "float32", "float32 bias", "bf16 table", "head dim 24", "last stride",
    "token stride", "unaligned", "table rows", "bias shape", "shift",
    "odd shift"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what):
    """`_check` runs before any launch: another type, head dim, layout,
    table or shift raises; so does a CPU call without the mask."""
    with pytest.raises(ValueError):
        KSW._check(*_operands(what))


def test_a_cpu_call_needs_the_materialised_mask():
    qkv, bias, table, shift = _operands()
    with pytest.raises(ValueError):
        KSW.attention(qkv, bias, table, shift, 32 ** -0.5)


def test_every_block_calls_the_window_attention_once(monkeypatch):
    """A BiRefNet forward, bfloat16 or float32, runs each Swin block's
    attention through `swin_attention.attention` once, on its unpadded
    grid, with the block's shift: 16 blocks at two scales with the tiny
    widths. The replays of a compiled run carry the kernel's launch
    counter."""
    calls = []
    real = KSW.attention

    def spy(qkv, bias, table, shift, scale, mask=None):
        calls.append((tuple(qkv.shape[1:3]), shift))
        return real(qkv, bias, table, shift, scale, mask=mask)

    monkeypatch.setattr(KSW, "attention", spy)
    cfg = B.BiRefNetConfig(embed_dim=24, depths=(2, 2, 2, 2),
                           num_heads=(1, 2, 4, 8))
    for half in (True, False):
        net = B.BiRefNet(cfg, half=half)
        B.seeded_init(net, torch.Generator().manual_seed(2))
        calls.clear()
        with torch.no_grad():
            net(torch.randn(1, 3, 64, 64))
        grids = [(16, 16), (8, 8), (4, 4), (2, 2), (8, 8), (4, 4), (2, 2),
                 (1, 1)]
        assert calls == [(g, s) for g in grids for s in (0, 6)]
    assert (KSW, "LAUNCHES") in replayed_counters()
