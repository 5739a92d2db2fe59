// K2: the matting-Laplacian precompute in one pass over 3x3 windows.
//
// Replaces image_segmenter_tpu/kernels/pallas_precompute.py:_kernel (via
// precompute_planes). In: (B, 3, H, W) f32 image in [0, 1]. Out:
// (B, 12, H, W) f32 planes [i1, i2, i3, l21, l31, l32, diag, n, mu_r,
// mu_g, mu_b, rankdef].
//
// Per window k (3x3, border-clipped, n members): means; three
// residual-accumulation moment passes (pass A: first-channel moments and
// the trace; pass B: residuals of ch2/ch3 on ch1; pass C: residual of ch3
// on ch1, ch2), because closed-form moments cancel in f32 against the
// eps = 1e-7 ridge; the ridge eps_w = max(eps, 1e-5 * trace); LDL pivots
// p1..p3 and multipliers l21, l31, l32; i_j = n / p_j; the exact
// rank-deficiency flag. Per pixel i: diag(L)_i = n_i - sum over the
// windows k covering i of (1 + quad_k(I_i - mu_k)) / n_k.
//
// Bound on this card: the instruction slots. Device memory sees 12 B in
// and 48 B out per pixel (42 us at 4 x 576 x 1024); the arithmetic is about
// 690 operations a pixel, none of them fused (the library is built without
// FMA contraction so that the floats are the plain version's), 18 of them
// IEEE divisions of some nine instructions each: more than 800
// instructions a pixel, 75-80 us of the card's instruction slots. So the
// design spends instructions on nothing else: no shared memory, no barrier,
// no value loaded or centred twice.
//
// Design: a warp walks down a strip of 30 output columns, one row of
// windows (a centre row) a step. Lane l owns column x0 - 1 + l: lanes 1..30
// are output columns, lanes 0 and 31 the halo windows the edge pixels'
// diag needs.
// - A lane loads its own column of the next image row (started one step
//   ahead) and gets the columns left and right of it by warp shuffle (lanes
//   0 and 31 load theirs); the two upper rows of the 3 x 3 window stay in
//   registers from the steps before. The 27 centred, masked values d are
//   formed once and serve pass A, pass B and the diag terms; pass C works on
//   pass B's residuals (rr = r3 - l32 r2, the same floats as the plain
//   version's expression). The count n and the in-image flags come from the
//   window's position, not from a plane of ones; where every window of the
//   warp lies inside the image (almost everywhere) the flags are all 1 and
//   the multiplications by them are left out. The twelve divisions by n
//   (three means, nine diag terms) share one reciprocal: quotient estimate,
//   exact remainder, one correction give the correctly rounded quotient
//   (div_n); the six divisions by the pivots stay IEEE divisions.
// - diag is summed where the plain version forms it: window k computes
//   g = (1 + quad_k(d_j)) / n_k for each of its nine members j, and pixel i
//   adds the nine g it is a member of in the plain version's shift order:
//   three from the centre row above (left, own, right lane: two shuffles),
//   three from its own, three from the row below. A lane carries the two
//   open sums; output row c - 1 closes in step c. Windows centred outside
//   the image give 0, as the plain version's zero padding does.
// - Every plane is stored by the lanes of a warp along a row.
// - The grid is strips x row runs x images, four warps a block, each warp
//   on its own; the caller chooses the run length (kernels/precompute.py:
//   run_rows) so that the warps fill the card once. A run recomputes the
//   two centre rows at its ends, a strip two of 32 columns.
// TMA and wgmma have nothing to give: there is no matrix product, and the
// loads are a fifth of the traffic of a kernel that memory does not bound.
// Sums keep the plain version's order (boxes columns then rows, moments
// shift-major); a masked member adds a signed zero where the plain version
// adds one, so the planes match the plain version bit for bit on the card,
// well inside the stated 1e-4 bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW = 30;             // output columns a warp walks down
constexpr int kWarps = 4;          // warps a block, each on its own strip
constexpr int kThreads = 32 * kWarps;
constexpr float kDelta = 1e-5f;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Walk {
  const float* im;     // the image's three planes
  float* o;            // the image's twelve output planes
  int64_t plane;
  int H, W, lane, gx, ex;
  bool col_in, ex_in;

  // row `row` of the image at the lane's column (cur) and, for lanes 0 and
  // 31, at the column beyond it (ext); zeros outside the image
  __device__ __forceinline__ void load_row(int row, float (&cur)[3],
                                           float (&ext)[3]) const {
    const bool rin = row >= 0 && row < H;
    const float* r = im + (int64_t)(rin ? row : 0) * W;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      cur[ch] = (rin && col_in) ? __ldg(r + ch * plane + gx) : 0.f;
      ext[ch] = (rin && ex_in) ? __ldg(r + ch * plane + ex) : 0.f;
    }
  }

  // w[3 ch + 0..2]: the row at columns gx - 1, gx, gx + 1
  __device__ __forceinline__ void spread(const float (&cur)[3],
                                         const float (&ext)[3],
                                         float (&w)[9]) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float l = __shfl_up_sync(kAll, cur[ch], 1);
      const float r = __shfl_down_sync(kAll, cur[ch], 1);
      w[3 * ch + 0] = lane == 0 ? ext[ch] : l;
      w[3 * ch + 1] = cur[ch];
      w[3 * ch + 2] = lane == 31 ? ext[ch] : r;
    }
  }
};

// x / n for a window count n (1, 2, 3, 4, 6 or 9) with rn = RN(1 / n):
// the quotient estimate, its exact remainder and one correction, which is
// the correctly rounded quotient (Markstein's final step; it is also what
// the compiler's own division does after it has formed the reciprocal).
// Twelve divisions by n a window share one reciprocal this way.
__device__ __forceinline__ float div_n(float x, float n, float rn) {
  const float q = x * rn;
  const float rem = __fmaf_rn(-q, n, x);
  return __fmaf_rn(rem, rn, q);
}

// The statistics of the window centred at (c, gx) from its three rows wa,
// wb, wc: the eleven planes stored if `store`, and g[3 (my + 1) + mx + 1],
// the window's term of the diag of its member (my, mx). EDGE: some member
// of some lane's window may lie outside the image; otherwise every member
// counts, n is 9, and the masks (factors of exactly 1) are left out.
template <bool EDGE>
__device__ __forceinline__ void window(const Walk& k, int c,
                                       const float (&wa)[9],
                                       const float (&wb)[9],
                                       const float (&wc)[9], float eps,
                                       bool store, float (&g)[9]) {
  const int gx = k.gx, H = k.H, W = k.W;
  float v[9];
  float n = 9.f, rn = 1.f / 9.f;
  if (EDGE) {
    const float vrow[3] = {c - 1 >= 0 ? 1.f : 0.f, 1.f, c + 1 < H ? 1.f : 0.f};
    const float vcol[3] = {gx - 1 >= 0 ? 1.f : 0.f, 1.f,
                           gx + 1 < W ? 1.f : 0.f};
#pragma unroll
    for (int j = 0; j < 9; ++j) v[j] = vrow[j / 3] * vcol[j % 3];
    n = (float)(((c - 1 >= 0) + 1 + (c + 1 < H))
                * ((gx - 1 >= 0) + 1 + (gx + 1 < W)));
    rn = 1.f / n;
  }
  // the means: 3x3 boxes summed over columns, then rows
  float mu[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float t0 = (wa[3 * ch] + wa[3 * ch + 1]) + wa[3 * ch + 2];
    const float t1 = (wb[3 * ch] + wb[3 * ch + 1]) + wb[3 * ch + 2];
    const float t2 = (wc[3 * ch] + wc[3 * ch + 1]) + wc[3 * ch + 2];
    mu[ch] = div_n((t0 + t1) + t2, n, rn);
  }
  // the centred, masked members, formed once
  float d0[9], d1[9], d2[9];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    d0[x] = wa[x] - mu[0];
    d1[x] = wa[3 + x] - mu[1];
    d2[x] = wa[6 + x] - mu[2];
    d0[3 + x] = wb[x] - mu[0];
    d1[3 + x] = wb[3 + x] - mu[1];
    d2[3 + x] = wb[6 + x] - mu[2];
    d0[6 + x] = wc[x] - mu[0];
    d1[6 + x] = wc[3 + x] - mu[1];
    d2[6 + x] = wc[6 + x] - mu[2];
  }
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      d0[j] *= v[j];
      d1[j] *= v[j];
      d2[j] *= v[j];
    }
  }
  // pass A: first-channel moments + covariance trace
  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a22 = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    a00 += d0[j] * d0[j];
    a01 += d0[j] * d1[j];
    a02 += d0[j] * d2[j];
    a11 += d1[j] * d1[j];
    a22 += d2[j] * d2[j];
  }
  const float tr = (a00 + a11) + a22;
  const float eps_w = fmaxf(kDelta * tr, eps);
  const float p1 = a00 + eps_w;
  const float l21 = a01 / p1;
  const float l31 = a02 / p1;
  // pass B: residuals of ch2/ch3 on ch1. A masked member's residuals are
  // zeros, so the plain version's factor v changes no bit
  float r2[9], r3[9];
  float q22 = 0.f, q23 = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    r2[j] = d1[j] - l21 * d0[j];
    r3[j] = d2[j] - l31 * d0[j];
    q22 += r2[j] * r2[j];
    q23 += r2[j] * r3[j];
  }
  const float p2 = q22 + eps_w * (1.f + l21 * l21);
  const float l32 = (q23 + eps_w * l21 * l31) / p2;
  // pass C: residual of ch3 on (ch1, ch2)
  float q3 = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float rr = r3[j] - l32 * r2[j];
    q3 += rr * rr;
  }
  const float bq = l21 * l32 - l31;
  const float p3 = q3 + eps_w * ((bq * bq + l32 * l32) + 1.f);
  const float rankdef = (q3 < kDelta * tr && tr > 1e-4f) ? 1.f : 0.f;
  const float i1 = n / p1, i2 = n / p2, i3 = n / p3;

  // (Sigma + eps/n I)^-1 = Linv' diag(i) Linv
  const float v00 = i1 + l21 * l21 * i2 + bq * bq * i3;
  const float v01 = -l21 * i2 - bq * l32 * i3;
  const float v02 = bq * i3;
  const float v11 = i2 + l32 * l32 * i3;
  const float v12 = -l32 * i3;
  const float v22 = i3;
  // this window's term of each member's diag (an in-image member's d is
  // I_j - mu_k as it stands; the others' terms are never read)
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float e0 = d0[j], e1 = d1[j], e2 = d2[j];
    const float quad =
        v00 * e0 * e0 + v11 * e1 * e1 + v22 * e2 * e2
        + 2.f * (v01 * e0 * e1 + v02 * e0 * e2 + v12 * e1 * e2);
    g[j] = div_n(1.f + quad, n, rn);
  }

  if (store) {
    const int64_t plane = k.plane;
    float* p = k.o + (int64_t)c * W + gx;
    p[0 * plane] = i1;
    p[1 * plane] = i2;
    p[2 * plane] = i3;
    p[3 * plane] = l21;
    p[4 * plane] = l31;
    p[5 * plane] = l32;
    p[7 * plane] = n;
    p[8 * plane] = mu[0];
    p[9 * plane] = mu[1];
    p[10 * plane] = mu[2];
    p[11 * plane] = rankdef;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
precompute_kernel(const float* __restrict__ img, int H, int W, float eps,
                  int run_rows, int strips, int runs, int warps,
                  float* __restrict__ out) {
  const int wid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wid >= warps) return;   // the whole warp
  const int strip = wid % strips;
  const int run = (wid / strips) % runs;
  const int64_t b = wid / (strips * runs);

  Walk k;
  k.plane = (int64_t)H * W;
  k.im = img + b * 3 * k.plane;
  k.o = out + b * 12 * k.plane;
  k.H = H;
  k.W = W;
  k.lane = threadIdx.x & 31;
  k.gx = strip * SW - 1 + k.lane;
  k.ex = k.lane == 0 ? k.gx - 1 : k.gx + 1;
  k.col_in = k.gx >= 0 && k.gx < W;
  k.ex_in = (k.lane == 0 || k.lane == 31) && k.ex >= 0 && k.ex < W;
  const int lane = k.lane, gx = k.gx;
  const bool col_out = lane >= 1 && lane <= SW && k.col_in;
  const int r0 = run * run_rows;
  const int r1 = min(r0 + run_rows, H);   // output rows [r0, r1)
  // every column any lane's window touches lies in the image
  const bool cols_inside = strip * SW - 2 >= 0 && strip * SW + 31 < W;
  const int nx = (gx - 1 >= 0) + 1 + (gx + 1 < W);

  // rows c - 1, c, c + 1 of the window; the row after them, on its way
  float wa[9], wb[9], wc[9], cur[3], ext[3];
  const int c0 = r0 - 1;
  k.load_row(c0 - 1, cur, ext);
  k.spread(cur, ext, wa);
  k.load_row(c0, cur, ext);
  k.spread(cur, ext, wb);
  k.load_row(c0 + 1, cur, ext);
  // the open diag sums of pixel rows c - 1 and c before step c
  float s1 = 0.f, s0 = 0.f;

  for (int c = c0; c <= r1; ++c) {
    k.spread(cur, ext, wc);
    if (c < r1) k.load_row(c + 2, cur, ext);

    float g[9];
    const bool store = col_out && c >= r0 && c < r1;
    if (cols_inside && c - 1 >= 0 && c + 1 < H) {
      window<false>(k, c, wa, wb, wc, eps, store, g);
    } else if (c >= 0 && c < H && k.col_in) {
      window<true>(k, c, wa, wb, wc, eps, store, g);
    } else {   // windows centred outside the image do not exist
#pragma unroll
      for (int j = 0; j < 9; ++j) g[j] = 0.f;
    }

    // ---- diag(L): each pixel adds the terms of the windows covering it, in
    // the plain version's shift order. Member (my, mx) of window (c, x) is
    // pixel (c + my, x + mx): pixel (y, x) takes from centre row c = y - dy
    // the members my = -dy of the lanes x - 1 (mx = +1), x and x + 1 (-1).
    const float up_o = __shfl_up_sync(kAll, g[2], 1);    // my -1
    const float dn_o = __shfl_down_sync(kAll, g[0], 1);
    const float up_m = __shfl_up_sync(kAll, g[5], 1);    // my 0
    const float dn_m = __shfl_down_sync(kAll, g[3], 1);
    const float up_n = __shfl_up_sync(kAll, g[8], 1);    // my +1
    const float dn_n = __shfl_down_sync(kAll, g[6], 1);
    const float closed = ((s1 + up_o) + g[1]) + dn_o;    // pixel row c - 1
    s1 = ((s0 + up_m) + g[4]) + dn_m;                    // pixel row c
    s0 = (up_n + g[7]) + dn_n;                           // pixel row c + 1
    const int y = c - 1;
    if (col_out && y >= r0) {
      const float ny = (float)(((y - 1 >= 0) + 1 + (y + 1 < H)) * nx);
      k.o[6 * k.plane + (int64_t)y * W + gx] = ny - closed;
    }

#pragma unroll
    for (int j = 0; j < 9; ++j) {
      wa[j] = wb[j];
      wb[j] = wc[j];
    }
  }
}

}  // namespace

// run_rows: output rows a warp covers (ceil(H / run_rows) runs an image).
extern "C" int iseg_precompute(const void* img, int batch, int H, int W,
                               float eps, int run_rows, void* out,
                               void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (run_rows < 1) return (int)cudaErrorInvalidValue;
  const int strips = (W + SW - 1) / SW;
  const int runs = (H + run_rows - 1) / run_rows;
  const int64_t warps = (int64_t)batch * strips * runs;
  if (warps > (int64_t)1 << 30) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  precompute_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, eps, run_rows, strips, runs,
      (int)warps, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
