"""CPU checks of what the redesigned K8 kernel rests on.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
Here, on the CPU, a numpy twin of csrc/hist_variants.cu's scheme: every
lane counts its bytes into a column of 8-bit counters of its own (word
`(v >> 2) * 32 + lane` of its warp's table), the block widens them into
int32 sums after `PERIODS[variant]` loads a thread, in two 16-bit halves
a word, thread t reading four columns at a time from a group that turns
with t, and the rows' totals add the blocks'. The twin must give
np.bincount and `hist_variant_plain` at ragged n and unaligned starts, on
random, all-equal, run and alpha-like rows; no counter may pass 255 and no
half-sum 65,535; every access of a lane lies in its own bank. The
wrapper's constants, the `.cu`'s and `_build.SIGNATURES` must agree.
"""

import ctypes
import inspect
import re

import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.bench import micro_hist_nibble as TMH
from image_segmenter_tpu_torch.bench import micro_precompute_hist as BENCH
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as K1

H100_SMS = 132
SRC = (_build.CSRC / "hist_variants.cu").read_text()
WARP_WORDS = 64 * 32     # words of one warp's table: 64 words x 32 lanes


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _table(name: str) -> list:
    body = re.search(rf"constexpr int {name}\[\] = \{{([^}}]*)\}};", SRC)
    return [int(v) for v in body.group(1).split(",")]


def group_columns(threads: int) -> np.ndarray:
    """(threads, 16) the group of four columns thread t reads at step i of
    a widening: part * 16 + ((i + t) & 15), as `widen` of the .cu."""
    t = np.arange(threads)[:, None]
    part = t % (threads // 64)
    return part * 16 + ((np.arange(16)[None] + t) & 15)


def widen_twin(cnt: np.ndarray, threads: int):
    """The block's int32 bin sums from its (threads, 256) byte counters
    (row warp * 32 + lane: that lane's column), as `widen` forms them;
    returns (sums (256,), the largest 16-bit half-sum met)."""
    assert cnt.max(initial=0) <= 255
    share = threads // 64
    words = cnt.reshape(threads, 64, 4)          # column, word, byte of word
    cols = (group_columns(threads)[..., None] >> 3) * 32 \
        + 4 * (group_columns(threads)[..., None] & 7) + np.arange(4)
    cols = cols.reshape(threads, 64)              # the thread's 64 columns
    word = np.arange(threads) // share
    part = words[cols, word[:, None]].sum(axis=1)  # (threads, 4) bytes' sums
    biggest = part.max(initial=0)
    total = part.reshape(64, share, 4).sum(axis=1)  # after the shuffles
    biggest = max(biggest, total.max(initial=0))
    return total.reshape(256), int(biggest)


def k8_walk(row: np.ndarray, misalign: int, blocks: int, period: int,
            threads: int = K8.THREADS):
    """One row counted as csrc/hist_variants.cu counts it with `blocks`
    blocks and a widening every `period` loads a thread. `misalign` is the
    row's address mod 16. Returns (totals (256,), largest byte counter,
    largest 16-bit half-sum, widenings)."""
    n = len(row)
    head = min((16 - misalign) & 15, n)
    nvec = (n - head) // 16
    body = row[head:head + 16 * nvec].reshape(nvec, 16)
    chunks = -(-nvec // threads)
    lanes = np.arange(threads)
    totals = np.zeros(256, np.int64)
    top_counter = top_half = widenings = 0
    for blk in range(blocks):
        cnt = np.zeros((threads, 256), np.int64)
        if blk == 0:  # head and tail, a byte a thread
            np.add.at(cnt, (np.arange(head), row[:head]), 1)
            tail = np.arange(head + 16 * nvec, n)
            np.add.at(cnt, (tail - head - 16 * nvec, row[tail]), 1)
        c = blk
        while True:  # the kernel's do-while: at least one widening
            for r in range(period):
                i = (c + r * blocks) * threads + lanes
                ok = i < nvec
                np.add.at(cnt, (np.repeat(lanes[ok], 16), body[i[ok]].ravel()),
                          1)
            top_counter = max(top_counter, int(cnt.max()))
            sums, half = widen_twin(cnt, threads)
            totals += sums
            top_half = max(top_half, half)
            widenings += 1
            cnt[:] = 0
            c += period * blocks
            if c >= chunks:
                break
    return totals, top_counter, top_half, widenings


def _cases():
    rng = np.random.default_rng(71)
    n = 70001
    run = rng.integers(0, 256, n, dtype=np.uint8)
    run[100:40000] = 255
    return {
        "random": rng.integers(0, 256, n, dtype=np.uint8),
        "all 0": np.zeros(n, np.uint8),
        "all 255": np.full(n, 255, np.uint8),
        "all 7": np.full(n, 7, np.uint8),
        "a run of 255": run,
        "alpha-like": BENCH.alpha_like(1, n, rng)[0],
        "shorter than a load": rng.integers(0, 256, 11, dtype=np.uint8),
        "one byte": np.array([200], np.uint8),
        "empty": np.zeros(0, np.uint8),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_k8_twin_is_exact(variant, name):
    """Head, body and tail meet every byte once at any alignment and block
    count; the widened sums are np.bincount and the plain version's."""
    row = CASES[name]
    ref = np.bincount(row, minlength=256)
    period = K8.PERIODS[variant]
    for misalign in (0, 1, 13):
        for blocks in (1, K8.blocks_per_row(len(row), 1, H100_SMS), 3):
            totals, top, half, _ = k8_walk(row, misalign, blocks, period)
            np.testing.assert_array_equal(totals, ref)
            assert top <= 255 and half <= 65535
    plain = K8.hist_variant_plain(torch.from_numpy(row)[None], variant)
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(plain[0].numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_k8_twin_equals_plain_on_rows(variant):
    """Several rows of one call, each its own walk: equal to
    `hist_variant_plain` row by row."""
    rng = np.random.default_rng(72)
    x = np.concatenate([rng.integers(0, 256, (2, 33333), dtype=np.uint8),
                        BENCH.alpha_like(2, 33333, rng)])
    blocks = K8.blocks_per_row(x.shape[1], len(x), H100_SMS)
    got = np.stack([k8_walk(r, 5, blocks, K8.PERIODS[variant])[0] for r in x])
    plain = K8.hist_variant_plain(torch.from_numpy(x), variant)
    np.testing.assert_array_equal(got.astype(np.float32), plain.numpy())


@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_k8_counters_stay_in_range_on_the_worst_row(variant):
    """All bytes equal is the worst case: one counter a lane takes every
    byte of a period. It reaches 16 x the period (plus the head and tail
    bytes in block 0), never 256; a 16-bit half-sum stays under 65,536."""
    period = K8.PERIODS[variant]
    row = np.full(4 * K8.THREADS * 16 * period + 7, 9, np.uint8)
    totals, top, half, widenings = k8_walk(row, 3, 1, period)
    assert totals[9] == len(row)
    assert top == 16 * period + 2 <= 255   # and a head and a tail byte
    # the first widening sums a whole period and the 13 + 10 head and tail
    assert half == K8.THREADS * 16 * period + 23 <= 65535
    assert widenings == 4
    # the bounds the .cu asserts hold for every variant's period
    assert 16 * K8.MAX_LOADS + 2 <= 255
    assert K8.THREADS * (16 * K8.MAX_LOADS + 2) < 65536


def test_k8_every_access_of_a_lane_is_in_its_bank():
    """Counting: lane L of any warp, any byte, lies in bank L. Widening:
    the eight threads of each phase of a 16-byte access meet eight
    different groups of four banks, and a thread reads each of its 64
    columns once."""
    lane = np.arange(32)[:, None]
    for warp in range(K8.THREADS // 32):
        v = np.arange(256)[None]
        addr = warp * WARP_WORDS + (v >> 2) * 32 + lane
        assert (addr % 32 == lane).all()
    groups = group_columns(K8.THREADS)
    for i in range(16):
        for phase in range(K8.THREADS // 8):
            g = groups[8 * phase:8 * phase + 8, i]
            assert len(set((g & 7).tolist())) == 8
    share = K8.THREADS // 64
    for t in range(K8.THREADS):
        assert sorted(groups[t]) == list(range((t % share) * 16,
                                               (t % share) * 16 + 16))


def test_k8_counting_step_addresses_and_increments():
    """count_word's shifts, read from the .cu: byte j of a word lands in
    word (b >> 2) * 32 of the lane's column, bits 7-12 of the offset and
    clear of the column's own bits, and adds 1 << 8 * (b & 3) (a funnel
    shift reads the low 5 bits of its amount)."""
    steps = re.findall(r"col \| \(\(w (<<|>>) (\d+)\) & 0x1F80u\), s(?: >> "
                       r"(\d+))?\)", SRC)
    assert len(steps) == 4
    rng = np.random.default_rng(73)
    w = np.concatenate([rng.integers(0, 1 << 32, 5000, dtype=np.uint64),
                        np.arange(256, dtype=np.uint64) * 0x01010101])
    sh = ((w & 0x03030303) << 3) & 0xFFFFFFFF
    cols = [4 * (warp * WARP_WORDS + lane) for warp in range(K8.THREADS // 32)
            for lane in (0, 17, 31)]
    for j, (op, bits, s_shift) in enumerate(steps):
        b = (w >> (8 * j)) & 0xFF
        moved = (w << int(bits)) if op == "<<" else (w >> int(bits))
        off = moved & 0x1F80
        np.testing.assert_array_equal(off, (b >> 2) * 32 * 4)
        amount = (sh >> int(s_shift or 0)) & 31
        np.testing.assert_array_equal(1 << amount, 1 << (8 * (b & 3)))
        for col in cols:
            assert col & 0x1F80 == 0
            np.testing.assert_array_equal(col | off, col + off)


def test_k8_wrapper_and_kernel_agree_on_their_constants():
    assert _const("kThreads") == K8.THREADS
    assert _const("kMaxLoads") == K8.MAX_LOADS
    assert _const("kBlocksPerSm") == K8.BLOCKS_PER_SM
    assert _const("kRow") == K1.SCRATCH_ROW
    steps, periods = _table("kSteps"), _table("kPeriods")
    assert dict(zip(steps, periods)) == {K8.STEPS[v]: K8.PERIODS[v]
                                         for v in K8.STEPS}
    for v, step in K8.STEPS.items():
        want = step // (K8.THREADS * 16) if step else K8.MAX_LOADS
        assert K8.PERIODS[v] == min(want, K8.MAX_LOADS)
    # 64 KB of counters a block: BLOCKS_PER_SM blocks fit the SM's 227 KB,
    # one more would not
    table = K8.THREADS // 32 * WARP_WORDS * 4
    assert table == 64 * 1024
    assert K8.BLOCKS_PER_SM * (table + 1024) <= 232448
    assert (K8.BLOCKS_PER_SM + 1) * table > 232448


def test_k8_is_one_launch_with_no_atomic_in_its_count():
    """No memset in the C entry, no cast in the wrapper, and the per-byte
    count is a plain load, add and store."""
    assert "cudaMemset" not in SRC
    assert ".to(torch.float32)" not in inspect.getsource(K8.hist_variant)
    for fn in ("add_at", "count_byte", "count_word", "count_vec"):
        body = re.search(rf"void {fn}\([^)]*\) \{{(.*?)\n\}}", SRC, re.S)
        assert body and "atomic" not in body.group(1), fn


def test_k8_signature_matches_the_c_entry():
    params = re.search(r'extern "C" int iseg_hist_variant\(([^)]*)\)', SRC)
    params = [" ".join(p.split()) for p in params.group(1).split(",")]
    assert params == ["const void* x", "int64_t n", "int batch", "int step",
                      "int blocks_per_row", "void* scratch", "void* out",
                      "void* stream"]
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert _build.SIGNATURES["iseg_hist_variant"] == [p, i64, i32, i32, i32,
                                                      p, p, p]


def test_k8_blocks_per_row():
    """Three resident blocks an SM over all rows, never more blocks than
    the row has periods for, never fewer than one."""
    per_sm = K8.BLOCKS_PER_SM * H100_SMS
    assert K8.blocks_per_row(2160 * 3840, 4, H100_SMS) == per_sm // 4
    assert K8.blocks_per_row(0, 4, H100_SMS) == 1
    assert K8.blocks_per_row(37 * 53, 2, H100_SMS) == 1
    assert K8.blocks_per_row(1 << 30, 1000, H100_SMS) == 1
    for b in (1, 2, 4, 7):
        for n in (1, 70000, 1 << 20, 1 << 27):
            k = K8.blocks_per_row(n, b, H100_SMS)
            assert 1 <= k <= max(1, per_sm // b)
            assert (k - 1) * K8.BLOCK_BYTES < max(n, 1)


def test_k8_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(CASES["random"][:4000].reshape(4, 1000))
    before, per = K8.LAUNCHES, dict(K8.VARIANT_LAUNCHES)
    for v in K8.STEPS:
        assert torch.equal(K8.hist_variant(x, v), K8.hist_variant_plain(x, v))
        assert torch.equal(K8.hist_variant(x, v), K1.hist256_plain(x))
    assert K8.LAUNCHES == before and K8.VARIANT_LAUNCHES == per
    with pytest.raises(ValueError):
        K8.hist_variant(x.to(torch.int32))
    with pytest.raises(ValueError):
        K8.hist_variant(x.reshape(-1))
    with pytest.raises(ValueError):
        K8.hist_variant(x, "N16")


def test_micro_hist_nibble_inputs():
    """The micro's inputs: random, a run of 255 at the head of each row,
    and alpha-like rows, every one of the asked size."""
    got = TMH.inputs(5000, 3)
    assert {"random", "random x3", "run x3", "alpha-like x3"} == set(got)
    for name, x in got.items():
        assert x.dtype == np.uint8 and x.shape == ((1 if "x" not in name
                                                    else 3), 5000)
    assert (got["run x3"][:, :TMH.RUN_LENGTH] == 255).all()
    hot = ((got["alpha-like x3"] == 0) | (got["alpha-like x3"] == 255)).mean()
    assert hot >= 0.9
