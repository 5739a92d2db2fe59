// BiRefNet's Swin-L window attention: for every frame, 12 x 12 window and
// head of a (shifted) token grid, softmax(q k^T * scale + bias) v, where
// bias[i, j] is the gathered relative-position table plus, in a shifted
// block, -100 between tokens from different regions of the roll, rounded
// to bfloat16 as one additive mask (models/birefnet.WindowAttention.mask).
//
// Replaces no TPU kernel: the JAX package has no BiRefNet. It was added to
// take the library attention and its copies out of the port's main path.
// There a Swin block padded its bfloat16 grid to a multiple of 12 (a
// copy), rolled it by 6 in a shifted block (a copy), cut it into windows
// (a copy), ran F.scaled_dot_product_attention with a materialised mask
// ((windows, heads, 144, 144) bfloat16, 120 MB a shifted block of stage 1
// at 4 x 1024 x 1024, one frame a call because the mask differs by
// window), then reversed the partition, rolled back and cropped: about 23
// ms of a 119 ms BiRefNet call on the H100. Here the roll, the pad and the
// partition are indexing: window token (y, x) of window (wy, wx) sits at
// rolled position (r, c) = (12 wy + y, 12 wx + x) and reads the grid at
// ((r + s) mod Hp, (c + s) mod Wp), s the shift, Hp and Wp the grid padded
// to multiples of 12. A position at or beyond the grid's H or W is a pad
// token, whose q, k and v are the qkv projection's bias (a zero row
// through the Linear, as the padded path made them; Swin's detection
// variant keeps pad keys in the softmax). The bias and the mask are formed
// in the score tiles from the float32 table; no mask reaches device
// memory. Each query's output goes to its own unrolled, uncropped position
// of a (B, H, W, C) grid, ready for `proj`; pad queries are computed and
// not written.
//
// Bound on this card: bytes. A BiRefNet call at 4 x 1024 x 1024 runs 48
// launches (24 blocks at two scales) over 975 MB of unpadded bfloat16
// grids: reading q, k and v and writing the output once is 3.9 GB, 1.16 ms
// at 3.35 TB/s, against 337 GFLOP of products on the padded grids (0.34 ms
// at 989 TFLOP/s). What stands between the two is the softmax's
// arithmetic: 2.6 G scores a call, each a bias lookup, an exponential and
// a few float32 operations.
//
// Design. A window is 144 tokens and a head 32 wide, so a block takes one
// window of one head whole: q, k and v (144 x 32 each) come in by cp.async
// in 16-byte pieces, a token's 64-byte head slice at a time, and the
// blocks of one window's heads run side by side (the head is the fastest
// block index), so a token's 3C-wide qkv row is read whole from L2. Three
// warps take three 16-query tiles each; a warp keeps its 16 x 144 scores
// in registers, so the softmax is a single pass with no online rescaling.
// Products are mma.sync m16n8k16 from ldmatrix fragments (d 32 is two
// k-slices; wgmma's 64-row tiles would waste a third of 144 queries). The
// block turns its head's column of the table into two tables of 529
// bfloat16 pairs in shared memory, entry k holding the table at k and
// k - 1, once as it is and once plus -100, so that one 32-bit read gives
// the bias of a thread's two adjacent keys (a pair starts at an even
// column, so it never crosses a window row or an even shift's cut). The
// table index of query (yi, xi) and key (yj, xj) is (yi - yj + 11) 23 +
// xi - xj + 11; a thread's key pairs j = 24 m + 8 rho + 2 tq lie at
// (2 m + c / 12, c % 12), c = 8 rho + 2 tq, so the index is a per-row base
// less kb[rho] less 46 m, m a constant of the unrolled loop: one
// shared-memory read a pair and no index arithmetic. Which table a pair
// reads comes from one bit a pair, set where the query's and key's regions
// differ in a shifted block's last window row or column. Three warps of at
// most 136 registers and 38 KB of shared memory let five blocks share an
// SM, so one block's copies overlap another's arithmetic. Two heads a
// block (whole 128-byte lines read, two blocks an SM) took 9 % longer a
// call on the H100, and loading v after q and k, so that the scores start
// before it lands, gained nothing.
//
// Arithmetic, as the configuration states it and as
// kernels/swin_attention.attention_plain computes it with the mask
// materialised: the table plus the mask rounded once to bfloat16, added
// to the float32 score q.k * scale (one fused multiply-add here, two
// roundings there); maxima, exponentials and sums in float32; the
// unnormalised probabilities rounded to bfloat16 for the P V product,
// which accumulates in float32; the output divided by the row's sum and
// rounded to bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWs = 12;                  // window side
constexpr int kN = kWs * kWs;            // tokens a window
constexpr int kD = 32;                   // head dim
constexpr int kLd = kD + 8;              // a token's row in shared memory
constexpr int kSpan = 2 * kWs - 1;       // the table's side
constexpr int kTable = kSpan * kSpan;    // the table's rows
constexpr int kCentre = (kWs - 1) * kSpan + kWs - 1;  // index of (0, 0)
constexpr int kWarps = 3;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = kN / 16;          // 16-query tiles a window
constexpr int kCols = kN / 8;            // 8-key columns of a score tile
constexpr int kPieces = kD / 8;          // 16-byte pieces of a head slice
constexpr float kMask = -100.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* qkv;           // (B, H, W, 3C): q, k, v side by side
  int64_t sb, sh, sw;        // its strides, in elements
  const bf16* bias;          // (3C,) the projection's bias: pad tokens
  const float* table;        // (529, heads) float32
  int64_t tk, th;            // its strides
  bf16* out;                 // (B, H, W, C)
  int h, w, c, heads, hp, wp, nwx, nwin, shift;
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

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

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

// One block a (frame, window, head); blockIdx.x = (frame window) heads +
// head. The bounds hold a thread to 136 registers, five blocks an SM.
__global__ void __launch_bounds__(kThreads, 5)
swin_attn_kernel(const Params p) {
  __shared__ __align__(16) bf16 sQKV[3][kN * kLd];
  __shared__ unsigned sT[2 * kTable];  // the pairs as they are, then - 100

  const int head = blockIdx.x % p.heads;
  const int fw = blockIdx.x / p.heads;
  const int b = fw / p.nwin, wi = fw - b * p.nwin;
  const int wy = wi / p.nwx, wx = wi - wy * p.nwx;
  const int tid = threadIdx.x;
  const bf16* frame = p.qkv + static_cast<int64_t>(b) * p.sb;

  // q, k, v of the window's tokens: a token's three head slices in four
  // 16-byte pieces each, from the grid, or from the bias for a pad token
  for (int u = tid; u < kN * 3 * kPieces; u += kThreads) {
    const int t = u / (3 * kPieces), part = u - t * 3 * kPieces;
    const int which = part / kPieces, piece = part - which * kPieces;
    const int y = t / kWs, x = t - y * kWs;
    int sr = wy * kWs + y + p.shift;
    if (sr >= p.hp) sr -= p.hp;
    int sc = wx * kWs + x + p.shift;
    if (sc >= p.wp) sc -= p.wp;
    const int col = which * p.c + head * kD + piece * 8;
    const bf16* src = sr < p.h && sc < p.w
                          ? frame + sr * p.sh + sc * p.sw + col
                          : p.bias + col;
    cp_async16(smem_addr(&sQKV[which][t * kLd + piece * 8]), src);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the head's column of the table as bfloat16 pairs (k, k - 1), plain and
  // masked, while the copies are in flight
  {
    const float* col = p.table + head * p.th;
    for (int k = tid; k < kTable; k += kThreads) {
      const float t0 = __ldg(col + k * p.tk);
      const float t1 = k > 0 ? __ldg(col + (k - 1) * p.tk) : 0.0f;
      sT[k] = pack(t0, t1);
      sT[kTable + k] = pack(t0 + kMask, t1 + kMask);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // the mma fragments' row, pair
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix, its row
  // the thread's key pairs: column jt = 3 m + rho of a score tile starts at
  // key 24 m + c, c = 8 rho + 2 tq, at window position (2 m + c / 12,
  // c % 12); kb[rho] its table offset less 46 m. Bit jt of krow, kcol:
  // that key lies in the second region of a shifted last window row or
  // column (row or column at or past 12 - shift)
  const int split = kWs - p.shift;
  int kb[3];
  unsigned krow = 0, kcol = 0;
#pragma unroll
  for (int rho = 0; rho < 3; ++rho) {
    const int c = 8 * rho + 2 * tq, cy = c / kWs, cx = c - cy * kWs;
    kb[rho] = kSpan * cy + cx;
#pragma unroll
    for (int m = 0; m < kCols / 3; ++m) {
      krow |= static_cast<unsigned>(2 * m + cy >= split) << (3 * m + rho);
      kcol |= static_cast<unsigned>(cx >= split) << (3 * m + rho);
    }
  }
  const bool last_row = p.shift > 0 && wy == p.hp / kWs - 1;
  const bool last_col = p.shift > 0 && wx == p.nwx - 1;

  const unsigned q_lane =
      smem_addr(&sQKV[0][((mi & 1) * 8 + ri) * kLd + (mi >> 1) * 8]);
  const unsigned k_lane =
      smem_addr(&sQKV[1][((mi >> 1) * 8 + ri) * kLd + (mi & 1) * 8]);
  const unsigned v_lane =
      smem_addr(&sQKV[2][((mi & 1) * 8 + ri) * kLd + (mi >> 1) * 8]);

  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int tile = warp; tile < kTiles; tile += kWarps) {
    float s[kCols][4];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      unsigned qf[4];
      ldsm_x4(qf, q_lane + (tile * 16 * kLd + ks * 16) * 2);
#pragma unroll
      for (int pp = 0; pp < kCols / 2; ++pp) {
        unsigned kf[4];
        ldsm_x4(kf, k_lane + (pp * 16 * kLd + ks * 16) * 2);
        mma(s[2 * pp], qf, kf[0], kf[1]);
        mma(s[2 * pp + 1], qf, kf[2], kf[3]);
      }
    }

    // scale, bias and mask; the rows' maxima
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tile * 16 + g + 8 * r;
      const int yi = i / kWs, xi = i - yi * kWs;
      unsigned sel = 0;  // bit jt: the pair reads the masked table
      if (last_row) sel |= yi >= split ? ~krow : krow;
      if (last_col) sel |= xi >= split ? ~kcol : kcol;
      const int a = kSpan * yi + xi + kCentre;
      const unsigned* row[3] = {sT + a - kb[0], sT + a - kb[1],
                                sT + a - kb[2]};
      float m = -INFINITY;
#pragma unroll
      for (int jt = 0; jt < kCols; ++jt) {
        const int masked = static_cast<int>((sel >> jt) & 1u);
        const unsigned u =
            row[jt % 3][masked * kTable - 2 * kSpan * (jt / 3)];
        float& s0 = s[jt][2 * r];
        float& s1 = s[jt][2 * r + 1];
        s0 = fmaf(s0, p.scale, lo(u));
        s1 = fmaf(s1, p.scale, hi(u));
        m = fmaxf(m, fmaxf(s0, s1));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      mx[r] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    }
    float l[2] = {0.0f, 0.0f};
    const float neg[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
#pragma unroll
    for (int jt = 0; jt < kCols; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jt][e] = ex2(fmaf(s[jt][e], kLog2e, neg[e >> 1]));
        l[e >> 1] += s[jt][e];
      }

    // o = P v, P rounded to bfloat16
    float o[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const unsigned a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int pp = 0; pp < kD / 16; ++pp) {
        unsigned vf[4];
        ldsm_x4_t(vf, v_lane + (kk * 16 * kLd + pp * 16) * 2);
        mma(o[2 * pp], a, vf[0], vf[1]);
        mma(o[2 * pp + 1], a, vf[2], vf[3]);
      }
    }

    // each real query's row at its own position of the grid
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int i = tile * 16 + g + 8 * r;
      const int yi = i / kWs, xi = i - yi * kWs;
      int sr = wy * kWs + yi + p.shift;
      if (sr >= p.hp) sr -= p.hp;
      int sc = wx * kWs + xi + p.shift;
      if (sc >= p.wp) sc -= p.wp;
      if (sr >= p.h || sc >= p.w) continue;
      bf16* dst = p.out +
                  ((static_cast<int64_t>(b) * p.h + sr) * p.w + sc) * p.c +
                  head * kD + tq * 2;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * r] / sum, o[j][2 * r + 1] / sum);
    }
  }
}

}  // namespace

// qkv (B, H, W, 3C) bfloat16 with strides (sb, sh, sw, 1) in elements,
// each a multiple of 8, 16-byte aligned; bias (3C,) bfloat16, 16-byte
// aligned; table (529, heads) float32 with strides (tk, th); C = 32
// heads; shift even, 0 to 10; out (B, H, W, C) bfloat16, contiguous.
extern "C" int iseg_swin_attention(const void* qkv, int64_t sb, int64_t sh,
                                   int64_t sw, const void* bias,
                                   const void* table, int64_t tk, int64_t th,
                                   int batch, int h, int w, int c, int heads,
                                   int shift, float scale, void* out,
                                   void* stream) {
  if (batch < 1 || h < 1 || w < 1 || heads < 1 || c != heads * kD ||
      shift < 0 || shift >= kWs || shift % 2 || sw < 3 * c || sb % 8 ||
      sh % 8 || sw % 8)
    return cudaErrorInvalidValue;
  Params p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.sb = sb; p.sh = sh; p.sw = sw;
  p.bias = static_cast<const bf16*>(bias);
  p.table = static_cast<const float*>(table);
  p.tk = tk; p.th = th;
  p.out = static_cast<bf16*>(out);
  p.h = h; p.w = w; p.c = c; p.heads = heads; p.shift = shift;
  p.hp = (h + kWs - 1) / kWs * kWs;
  p.wp = (w + kWs - 1) / kWs * kWs;
  p.nwx = p.wp / kWs;
  p.nwin = p.hp / kWs * p.nwx;
  p.scale = scale;
  const int64_t blocks = static_cast<int64_t>(batch) * p.nwin * heads;
  if (blocks >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      swin_attn_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  swin_attn_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
