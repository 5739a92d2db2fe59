"""Unique packed colours via sort + segment boundaries.

Counterpart of image_segmenter_tpu/ops/unique.py. The reference calls
np.unique on flattened pixel arrays; here the keys are sorted, segment
boundaries marked, and the first and last position of each rank found by
two binary searches into a table of static capacity. The true unique
count comes back as a 0-d tensor, so a caller makes the reference's
data-dependent choices with one scalar read.

Keys are int64 holding uint32 values (ops/color.pack_rgb_u32), so
`SENTINEL` 0xFFFFFFFF sorts after every real key. Integer work only: the
results equal the JAX package's.
"""

from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF


def _sorted_keys(packed: torch.Tensor, valid: torch.Tensor):
    keys = torch.where(valid, packed, SENTINEL)
    s = torch.sort(keys).values
    is_valid = s != SENTINEL
    boundary = torch.cat([is_valid[:1], (s[1:] != s[:-1]) & is_valid[1:]])
    return s, is_valid, boundary


def packed_unique(packed: torch.Tensor, valid: torch.Tensor, cap: int):
    """Unique values among packed[valid] with counts.

    packed (N,) int64 keys below SENTINEL, valid (N,) bool, cap the table
    capacity. Returns values (cap,) int64 (the first n_unique entries are
    the sorted unique keys, the rest SENTINEL; past `cap` only the smallest
    cap keys are returned), counts (cap,) float32 and n_unique () int32,
    the true number of unique valid keys.
    """
    s, is_valid, boundary = _sorted_keys(packed, valid)
    seg = torch.cumsum(boundary.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n_unique = boundary.sum().to(torch.int32)
    # The sentinel tail must not inherit the last valid rank (it would
    # inflate that rank's count): push it past every real rank. It stays
    # sorted, since sentinels sort last.
    seg = torch.where(is_valid, seg, 1 << 30)
    ranks = torch.arange(cap, dtype=torch.int32, device=packed.device)
    left = torch.searchsorted(seg, ranks, right=False)
    right = torch.searchsorted(seg, ranks, right=True)
    in_range = ranks < n_unique
    values = torch.where(in_range,
                         s[torch.clamp(left, 0, s.shape[0] - 1)], SENTINEL)
    counts = torch.where(in_range, (right - left).to(torch.float32), 0.0)
    return values, counts, n_unique


def sorted_weighted_sample(packed: torch.Tensor, valid: torch.Tensor,
                           cap: int):
    """Systematic weighted sample of the key distribution: sort the keys
    and take every ceil(N / cap)-th one with weight = stride. Invalid slots
    come back as SENTINEL with weight 0."""
    n = packed.shape[0]
    keys = torch.where(valid, packed, SENTINEL)
    s = torch.sort(keys).values
    stride = max(1, -(-n // cap))
    sub = s[stride // 2::stride][:cap]
    if sub.shape[0] < cap:
        sub = torch.nn.functional.pad(sub, (0, cap - sub.shape[0]),
                                      value=SENTINEL)
    w = torch.where(sub != SENTINEL, float(stride), 0.0)
    return sub, w


def count_unique(packed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of unique values among packed[valid]: () int32."""
    return _sorted_keys(packed, valid)[2].sum().to(torch.int32)


def pack_rgba_u32(rgba_u8: torch.Tensor) -> torch.Tensor:
    """Pack (..., 4) uint8 RGBA into (...,) keys r<<24|g<<16|b<<8|a (int64:
    the key fills all 32 bits)."""
    c = rgba_u8.to(torch.int64)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]
