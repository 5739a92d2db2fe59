"""jax.random's threefry2x32 stream on torch tensors.

The JAX package seeds its k-means restarts and its pixel samples with
`jax.random` (solvers/kmeans.py:98-110,330-339, compat/color_simplify.py:
416-418, compat/_perceptual.py:77-78). For the port to make the same
choices from the same seed it needs the same numbers, so this module
repeats jax 0.9's default generator: threefry2x32 with
`jax_threefry_partitionable=True`. In that mode the bits of an array come
from a 64-bit counter over its flat (row-major) index, split into two
32-bit words that are hashed under the key; a 32-bit draw is the xor of
the two output words, and `split` and `fold_in` hash counters the same
way (jax/_src/prng.py:1156-1200).

Every function takes its key; there is no global state. A key is a pair
of Python ints (the two uint32 words), so it lives on no device: `split`
and `fold_in` hash a handful of words on the host, and only the draws
(`bits`, `uniform`, `gumbel`, `categorical`) run on `device`.

uint32 arithmetic is done in int32 tensors: addition and xor have the
same bits in two's complement, a rotation is built from a left shift and
a masked right shift. `bits` returns the words as int64 in [0, 2^32).

Integer results equal jax's bit for bit, and so does `uniform` (integer
work and one exact subtraction). `gumbel` takes two logarithms, which
round by library: on the CPU within 2 ulp of jax, counted at the size of
max(|g|, 1) (the inner logarithm is near 1 where g is near 0, so its last
bit is an absolute error of that size in g).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _s32(v: int) -> int:
    """The int32 with the bits of the uint32 `v`."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k1, k2): int32 tensors holding uint32 bits; the
    key words may be Python ints (as int32) or tensors that broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _s32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def _hash_host(key: Key, hi: Sequence[int], lo: Sequence[int]):
    """Hash a few counters on the host: two lists of uint32 ints."""
    x0 = torch.tensor([_s32(v) for v in hi], dtype=torch.int32)
    x1 = torch.tensor([_s32(v) for v in lo], dtype=torch.int32)
    y0, y1 = _threefry2x32(_s32(key[0]), _s32(key[1]), x0, x1)
    return ([int(v) & _M32 for v in y0.tolist()],
            [int(v) & _M32 for v in y1.tolist()])


def key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with jax's 64-bit types off (its default):
    the seed is a 32-bit integer, so the high word is 0."""
    return (0, int(seed) & _M32)


def split(k: Key, num: int = 2) -> List[Key]:
    """jax.random.split(k, num): key i is the hash of the counter i."""
    y0, y1 = _hash_host(k, [0] * num, list(range(num)))
    return list(zip(y0, y1))


def fold_in(k: Key, data: int) -> Key:
    """jax.random.fold_in(k, data) for a uint32 `data`."""
    y0, y1 = _hash_host(k, [0], [int(data) & _M32])
    return (y0[0], y1[0])


# the key words of a batch of keys, by (keys, device). On a CUDA device
# they are made by a copy from host memory, which a stream that captures
# a CUDA graph refuses, so they are made once, outside the capture (at a
# compiled program's warm-up), and kept for the graphs that read them. A
# key depends only on its seed and the draw's place in the stream, so the
# entries are few: one for each k-means++ step of each seed.
_WORDS: dict = {}


def _key_words(keys: Sequence[Key], device):
    """The key words of a batch of keys as int32 tensors (R, 1)."""
    cache = (tuple(tuple(k) for k in keys), str(torch.device(device)))
    words = _WORDS.get(cache)
    if words is None:
        words = _WORDS[cache] = torch.tensor(
            [[_s32(k[0]), _s32(k[1])] for k in keys], dtype=torch.int32,
            device=device)
    return words[:, 0:1], words[:, 1:2]


def _bits32(keys: Sequence[Key], shape, device) -> torch.Tensor:
    """(len(keys), *shape) int32: for each key the 32-bit words jax draws
    for an array of `shape` (counter = flat index, output words xor-ed)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    lo = (idx & _M32).to(torch.int32)   # wraps to the same low 32 bits
    hi = (idx >> 32).to(torch.int32)
    k1, k2 = _key_words(keys, device)
    y0, y1 = _threefry2x32(k1, k2, hi[None], lo[None])
    return (y0 ^ y1).reshape(len(keys), *shape)


def bits(k: Key, shape=(), device="cpu") -> torch.Tensor:
    """jax.random.bits(k, shape) (uint32) as int64 in [0, 2^32)."""
    shape = tuple(shape)
    return _bits32([k], shape, device)[0].to(torch.int64) & _M32


def _uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from 32-bit words: the top 23 bits become the
    mantissa of a float in [1, 2), less 1."""
    mant = ((b >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.view(torch.float32) - 1.0


def uniform(k: Key, shape=(), device="cpu") -> torch.Tensor:
    """jax.random.uniform(k, shape): float32 in [0, 1)."""
    return _uniform_from_bits(_bits32([k], tuple(shape), device)[0])


def _gumbel_from_bits(b: torch.Tensor) -> torch.Tensor:
    # jax's "low" mode: uniform in [tiny, 1) as max(tiny, u * (1 - tiny) +
    # tiny), then -log(-log(u)). In float32 1 - tiny is 1.
    u = _uniform_from_bits(b)
    u = torch.clamp_min(u + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def gumbel(k: Key, shape=(), device="cpu") -> torch.Tensor:
    """jax.random.gumbel(k, shape): float32, default ("low") mode."""
    return _gumbel_from_bits(_bits32([k], tuple(shape), device)[0])


def categorical_batched(keys: Sequence[Key], logits: torch.Tensor,
                        num: int | None = None) -> torch.Tensor:
    """jax.random.categorical(keys[r], logits[r], shape=(num,)) for every
    r: logits (R, N) float32 -> (R, num) int64 (or (R,) for num=None).
    The Gumbel noise of key r has shape (num, N) and is added to the
    logits' row; the first maximum wins, as jnp.argmax."""
    r, n = logits.shape
    shape = (n,) if num is None else (num, n)
    g = _gumbel_from_bits(_bits32(keys, shape, logits.device))
    z = g + (logits if num is None else logits[:, None, :])
    return torch.argmax(z, dim=-1)


def categorical(k: Key, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """jax.random.categorical(k, logits, shape=shape) for 1-D logits and
    `shape` None or (num,): int64 indices."""
    num = None if shape is None else int(tuple(shape)[0])
    return categorical_batched([k], logits[None], num)[0]
