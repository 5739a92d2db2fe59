// SAM's encoder attention: for every head of every window or frame,
// softmax(q k^T * scale + bias) v, where bias[i, j] is the decomposed
// relative-position bias of segment-anything's add_decomposed_rel_pos,
// bf16(rel_h[i, j / w] + rel_w[i, j % w]) on an h x w token grid.
//
// Replaces no TPU kernel: the JAX package has no SAM. It was added to take
// the library attention (F.scaled_dot_product_attention, cuDNN's flash
// kernel) and its materialised bias out of the port's main path. There the
// bias was a dense bfloat16 (B', heads, n, n) mask, 2.1 GB for a global
// block of ViT-H at 4 x 4096 tokens, written and read again; it carries
// n (h + w) numbers. Here each score tile adds its bias from the two small
// tables, which the einsums of models/sam.Attention make, and the bias
// never reaches device memory.
//
// Bound on this card: the tensor cores. A global block of ViT-H (4 frames,
// 16 heads, 4096 tokens, d 80) is 344 GFLOP of products against 126 MB of
// q, k, v, output and tables (0.35 ms at 989 TFLOP/s); a windowed one (100
// windows of 196 tokens) 19.7 GFLOP against 128 MB, near the ridge.
//
// One algorithm, FlashAttention-2's (Dao 2023): a block walks the keys in
// tiles with an online softmax in float32 (a running maximum and sum a
// row), so that no score leaves the chip. Warps of 16 queries multiply
// with mma.sync m16n8k16 from ldmatrix fragments; k and v tiles come in
// two cp.async buffers, their rows in shared memory padded by 8 elements
// against bank conflicts. A key tile is whole grid rows, each in a fixed
// number of slots, so that the key of a slot, and with it the bias's
// rel_w term, is the same in every tile: a thread keeps its rel_w values
// in registers, and reads one rel_h value a grid row a tile. Slots past a
// row's w keys and rows past the grid score -inf. The tiling follows the
// grid's width (`launch`):
// - the 14 x 14 windows (rows of up to 16 keys): a tile is two grid rows
//   of 16 slots, 32 slots against 196 keys wasting fewer than 64 would,
//   and a block four warps: 196 tokens are a short problem, and many
//   small blocks an SM hide a block's start best;
// - the global grid (rows of 17-64 keys; 64 at 1024 x 1024): a tile is
//   one grid row of 64 slots, and a block eight warps, so that each k and
//   v tile serves 128 queries.
// It reads q, k and v in place from the qkv projection (a token's row of
// heads side by side) and writes the output as (B', n, heads * d), ready
// for `proj`; the head dim is 16-wide k-slices, 80 as 5, not padded to
// 128. Queries past n are computed on zeros or on other tokens and not
// written.

// Arithmetic, as the configuration states it: the bias is rounded to
// bfloat16 (each pair of terms added with one rounding) and added to the
// float32 score q.k * scale; maxima, exponentials and sums are float32; the
// unnormalised probabilities are rounded to bfloat16 for the P V product,
// which accumulates in float32; the output is divided by the row's sum and
// rounded to bfloat16. The plain version, kernels/sam_attention.
// attention_plain, does the same with the bias materialised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// How far (log2 units) a row's maximum may rise before the running sums
// are rescaled: until then its weights are exp2(s - m) against a stale m,
// at most 2^8, which bfloat16 and float32 hold with their relative
// precision, and the output's division by the row's sum cancels the scale.
constexpr float kRescale = 8.0f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t qn, kn, vn;  // a token's stride, in elements
  const bf16* rh;      // rel_h (B' heads, h, w, h)
  int64_t rhb, rhy, rhx, rhk;
  const bf16* rw;      // rel_w (B' heads, h, w, w)
  int64_t rwb, rwy, rwx, rwk;
  bf16* out;           // (B', n, heads * d)
  int heads, n, gh, gw;
  int tiles, mblocks;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// a + b of two bfloat16 pairs, each sum rounded once to bfloat16
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 z = __hadd2(x, y);
  return *reinterpret_cast<unsigned*>(&z);
}

__device__ __forceinline__ float lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

// The softmax of one score tile. s holds a thread's scores of rows r = 0,
// 1 (the m16n8 accumulator layout: column 8 j + 2 tq (+1)); `hv[r][q]`
// the rel_h pair of grid row q of the tile, `rwp[j][r]` the rel_w pair of
// the thread's columns. Adds the bias, finds the rows' maxima, rescales o
// and l where one rose by more than kRescale, and leaves exp2 of the
// scores against the running maxima in s.
template <int NT, int DT, int SLOTS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NT][4], const unsigned (&hv)[2][NT * 8 / SLOTS],
    const unsigned (&rwp)[NT][2], float scale, float (&m_run)[2],
    float (&l_run)[2], float (&o)[DT][4]) {
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned bias = add2(hv[r][j * 8 / SLOTS], rwp[j][r]);
      float& s0 = s[j][r * 2];
      float& s1 = s[j][r * 2 + 1];
      s0 = fmaf(s0, scale, lo(bias));
      s1 = fmaf(s1, scale, hi(bias));
      mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
    }
  }
  bool grow = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    grow |= (mx[r] - m_run[r]) * kLog2e > kRescale;
  }
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      const float alpha = ex2((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][r * 2] *= alpha;
        o[j][r * 2 + 1] *= alpha;
      }
    }
  }
  const float neg[2] = {-m_run[0] * kLog2e, -m_run[1] * kLog2e};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[j][c] = ex2(fmaf(s[j][c], kLog2e, neg[c >> 1]));
      l_run[c >> 1] += s[j][c];
    }
}

// rel_h of a block's rows (`rows` of them from m0) into shared memory, one
// bfloat16 each: -inf past the grid's last row (those slots score -inf),
// zeros for queries past n. Eight independent loads a thread at a time.
__device__ __forceinline__ void load_rel_h(const Params& p, int bh, int m0,
                                           int rows, int hp, bf16* dst,
                                           int tid, int threads) {
  const bf16 kZero = __float2bfloat16_rn(0.0f);
  const bf16 kNegInf = __float2bfloat16_rn(-INFINITY);
  for (int base = tid; base < rows * hp; base += threads * 8) {
    bf16 val[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * threads;
      const int r = i / hp, c = i - r * hp, row = m0 + r;
      const int y = row / p.gw, x = row - y * p.gw;
      val[u] = row >= p.n ? kZero
               : c >= p.gh ? kNegInf
                           : __ldg(p.rh + bh * p.rhb + y * p.rhy +
                                   x * p.rhx + c * p.rhk);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (base + u * threads < rows * hp) dst[base + u * threads] = val[u];
  }
}

// A thread's rel_w pairs for one query row: columns 8 j + 2 tq (+1) of a
// tile, whose slot lies at kx = column % SLOTS of its grid row; -inf where
// that is off the grid (kx >= w), zeros for a query past n. The same in
// every tile, so kept packed in registers across the loop.
template <int NT, int SLOTS>
__device__ __forceinline__ void load_rel_w(const Params& p, int bh, int row,
                                           int tq, unsigned (&rwp)[NT][2],
                                           int r) {
  const bf16 kZero = __float2bfloat16_rn(0.0f);
  const bf16 kNegInf = __float2bfloat16_rn(-INFINITY);
  const int y = row / p.gw, x = row - y * p.gw;
  const bf16* tw = p.rw + bh * p.rwb + y * p.rwy + x * p.rwx;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int kx = (j * 8 + tq * 2) % SLOTS;
    const bf16 w0 = row >= p.n ? kZero
                    : kx < p.gw ? __ldg(tw + kx * p.rwk) : kNegInf;
    const bf16 w1 = row >= p.n ? kZero
                    : kx + 1 < p.gw ? __ldg(tw + (kx + 1) * p.rwk) : kNegInf;
    rwp[j][r] = bits(w0, w1);
    asm volatile("" : "+r"(rwp[j][r]));
  }
}

// The output rows of a thread: o divided by the row's sum (the sum of the
// four threads of the row), as (B', n, heads * d).
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, int b, int head,
                                           int row0, int tq,
                                           const float (&o)[D / 8][4],
                                           const float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= p.n) continue;
    bf16* dst = p.out + (static_cast<int64_t>(b) * p.n + row) *
                            (p.heads * D) + head * D + tq * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][r * 2] / l, o[j][r * 2 + 1] / l);
  }
}

// ---------------------------------------------------------------------------
// The kernel: mma.sync m16n8k16, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// ldmatrix from a shared-memory address (bytes)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grids at most SLOTS wide, RPT grid rows a key tile, WARPS warps of 16
// queries a block (`launch` says which). The bounds hold a thread to 128
// registers, so that two blocks of eight warps or four of four share an
// SM; at d 80 the global tiling spills a few registers there, and one
// block an SM with all it wants was slower (1.72 against 1.55 ms a ViT-H
// global block on the H100).
template <int D, int SLOTS, int RPT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
sam_attn_kernel(const Params p) {
  constexpr int BM = 16 * WARPS;   // queries a block
  constexpr int BN = SLOTS * RPT;  // slots a key tile
  constexpr int THREADS = 32 * WARPS;
  constexpr int LD = D + 8;        // a row in shared memory, padded
  constexpr int KS = D / 16;       // k-slices of the head dim
  constexpr int NT = BN / 8;       // 8-slot columns of a score tile
  constexpr int DT = D / 8;        // 8-wide columns of the output
  constexpr int CH = D / 8;        // 16-byte pieces of a row
  constexpr int RSTEP = THREADS / CH;  // rows a pass of the copy
  constexpr int PASSES = (BN + RSTEP - 1) / RSTEP;

  const int n = p.n, gh = p.gh, gw = p.gw, tiles = p.tiles;
  const int hp = tiles * RPT;  // rel_h columns, padded to whole tiles

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;        // two buffers
  bf16* sV = sK + 2 * BN * LD;    // two buffers
  bf16* sRh = sV + 2 * BN * LD;   // BM x hp

  const int bh = blockIdx.x / p.mblocks;
  const int m0 = (blockIdx.x - bh * p.mblocks) * BM;
  const int b = bh / p.heads, head = bh - b * p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // the mma fragments' row, pair
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix, its row
  const int64_t tok0 = static_cast<int64_t>(b) * n;  // the window's first

  // the copies: a thread takes one 16-byte column of rows RSTEP apart
  const int ccol = tid % CH, crow = tid / CH;
  const bool copier = crow < RSTEP;
  {
    const bf16* qsrc = p.q + tok0 * p.qn + head * D + ccol * 8;
#pragma unroll
    for (int k = 0; k < (BM + RSTEP - 1) / RSTEP; ++k) {
      const int r = crow + k * RSTEP, row = m0 + r;
      if (copier && r < BM)
        cp_async16(smem_addr(sQ + r * LD + ccol * 8),
                   row < n ? qsrc + row * p.qn : qsrc, row < n);
    }
  }
  // slot r of tile t holds key (t RPT + r / SLOTS, r % SLOTS) of the grid,
  // or zeros where that lies off the grid
  const bf16* ksrc = p.k + tok0 * p.kn + head * D + ccol * 8;
  const bf16* vsrc = p.v + tok0 * p.vn + head * D + ccol * 8;
  const int kn = static_cast<int>(p.kn), vn = static_cast<int>(p.vn);
  const unsigned skv = smem_addr(sK + crow * LD + ccol * 8);
  constexpr unsigned kKV = 2 * BN * LD * 2;  // sK to sV, bytes
  auto load_kv = [&](int t) {
    if (!copier) return;
    const bf16* kt = ksrc + static_cast<int64_t>(t) * RPT * gw * p.kn;
    const bf16* vt = vsrc + static_cast<int64_t>(t) * RPT * gw * p.vn;
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int r = crow + k * RSTEP;
      if (BN % RSTEP != 0 && r >= BN) break;
      const int kx = r % SLOTS, key = (r / SLOTS) * gw + kx;
      const bool ok = t * RPT + r / SLOTS < gh && kx < gw;
      const unsigned dst = skv + ((t & 1) * BN + k * RSTEP) * LD * 2;
      cp_async16(dst, ok ? kt + key * kn : ksrc, ok);
      cp_async16(dst + kKV, ok ? vt + key * vn : vsrc, ok);
    }
  };
  load_kv(0);  // with q
  asm volatile("cp.async.commit_group;\n" ::);
  load_rel_h(p, bh, m0, BM, hp, sRh, tid, THREADS);
  const int row0 = warp * 16 + g;  // the thread's rows: row0, row0 + 8
  unsigned rwp[NT][2];
  load_rel_w<NT, SLOTS>(p, bh, m0 + row0, tq, rwp, 0);
  load_rel_w<NT, SLOTS>(p, bh, m0 + row0 + 8, tq, rwp, 1);

  const bool active = m0 + warp * 16 < n;  // a warp with a query before n
  // the lane's ldmatrix rows: of q, and of the first k and v buffers
  const unsigned q_lane =
      smem_addr(sQ + (warp * 16 + (mi & 1) * 8 + ri) * LD + (mi >> 1) * 8);
  const unsigned k_lane =
      smem_addr(sK + ((mi >> 1) * 8 + ri) * LD + (mi & 1) * 8);
  const unsigned v_lane =
      smem_addr(sV + ((mi & 1) * 8 + ri) * LD + (mi >> 1) * 8);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);  // tile t (at t = 0, q)
    // tile t is in; every warp is done with tile t - 1, whose buffers the
    // next copy fills
    __syncthreads();
    if (t + 1 < tiles) load_kv(t + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if (!active) continue;
    const unsigned kt = k_lane + (t & 1) * BN * LD * 2;
    const unsigned vt = v_lane + (t & 1) * BN * LD * 2;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qf[4];
      ldsm_x4(qf, q_lane + ks * 32);
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        unsigned kf[4];
        ldsm_x4(kf, kt + (pp * 16 * LD + ks * 16) * 2);
        mma(s[2 * pp], qf, kf[0], kf[1]);
        mma(s[2 * pp + 1], qf, kf[2], kf[3]);
      }
    }

    unsigned hv[2][RPT];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const unsigned h =
            __bfloat16_as_ushort(sRh[(row0 + 8 * r) * hp + t * RPT + q]);
        hv[r][q] = h | (h << 16);
      }
    softmax_tile<NT, DT, SLOTS>(s, hv, rwp, p.scale, m_run, l_run, o);

    // o += P v, P rounded to bfloat16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const unsigned a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int pp = 0; pp < D / 16; ++pp) {
        unsigned vf[4];
        ldsm_x4_t(vf, vt + (kk * 16 * LD + pp * 16) * 2);
        mma(o[2 * pp], a, vf[0], vf[1]);
        mma(o[2 * pp + 1], a, vf[2], vf[3]);
      }
    }
  }
  if (active) store_rows<D>(p, b, head, m0 + row0, tq, o, l_run);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, int SLOTS, int RPT, int WARPS>
cudaError_t launch_tiled(Params p, int batch_heads, cudaStream_t stream) {
  constexpr int LD = D + 8, BM = 16 * WARPS, BN = SLOTS * RPT;
  p.tiles = (p.gh + RPT - 1) / RPT;
  p.mblocks = (p.n + BM - 1) / BM;
  const size_t smem =
      sizeof(bf16) * ((BM + 4 * BN) * LD + BM * p.tiles * RPT);
  auto kernel = sam_attn_kernel<D, SLOTS, RPT, WARPS>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<batch_heads * p.mblocks, 32 * WARPS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tiling by the grid's width: rows of up to 16 keys (the windows) two
// a tile of 32 slots, four warps a block; rows of 17-64 (the global grid)
// one a tile of 64 slots, eight warps a block.
template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.gw <= 16) return launch_tiled<D, 16, 2, 4>(p, batch * p.heads, stream);
  return launch_tiled<D, 64, 1, 8>(p, batch * p.heads, stream);
}

}  // namespace

// q, k, v (B', heads, n, d) bfloat16 with the strides given, in elements:
// the last 1, the head's d (heads side by side in a token's row), the
// window's or frame's n times the token's (tokens back to back), each a
// multiple of 8, the pointers 16-byte aligned; rel_h (B' heads, h, w, h),
// rel_w (B' heads, h, w, w) bfloat16 with theirs; n = h * w, w at most
// 64; d 16, 64 or 80; out (B', n, heads * d) bfloat16, contiguous.
extern "C" int iseg_sam_attention(
    const void* q, int64_t qb, int64_t qh, int64_t qn, const void* k,
    int64_t kb, int64_t kh, int64_t kn, const void* v, int64_t vb, int64_t vh,
    int64_t vn, const void* rel_h, int64_t rhb, int64_t rhy, int64_t rhx,
    int64_t rhk, const void* rel_w, int64_t rwb, int64_t rwy, int64_t rwx,
    int64_t rwk, int batch, int heads, int gh, int gw, int d, float scale,
    void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(gh) * gw;
  if (gw < 1 || gw > 64 || gh < 1 || qh != d || kh != d || vh != d ||
      qb != n * qn || kb != n * kn || vb != n * vn)
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.qn = qn; p.kn = kn; p.vn = vn;
  p.rh = static_cast<const bf16*>(rel_h);
  p.rhb = rhb; p.rhy = rhy; p.rhx = rhx; p.rhk = rhk;
  p.rw = static_cast<const bf16*>(rel_w);
  p.rwb = rwb; p.rwy = rwy; p.rwx = rwx; p.rwk = rwk;
  p.out = static_cast<bf16*>(out);
  p.heads = heads;
  p.n = static_cast<int>(n);
  p.gh = gh;
  p.gw = gw;
  p.tiles = 0;
  p.mblocks = 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(p, batch, s);
    case 64: return launch<64>(p, batch, s);
    case 80: return launch<80>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}
