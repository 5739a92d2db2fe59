// K6: L @ p of the matting Laplacian, recomputing the window means.
//
// Replaces image_segmenter_tpu/kernels/pallas_matting.py:_kernel (via
// matvec_planes). In: p_pad (B, Hp, Wp), p zero-padded by 2 (Hp = H + 4,
// Wp = W + 4 rounded up to 128), and the static planes (B, 10, Hp, Wp)
// [valid, img_r, img_g, img_b, i1, i2, i3, l21, l31, l32], padded alike.
// Out: (B, Ho, Wp), Ho = ceil(H / 32) * 32, the matvec at [:, :H, :W].
//
// Per centre k (halo 1): n = 9-shift sum of valid; ninv = 1 / max(n, 1);
// mu_c = (sum valid * img_c) * ninv; pbar = (sum valid * p) * ninv;
// cov_c = sum (img_c - mu_c) * (valid * p); the packed-LDL solve on
// cov * ninv; b = pbar - ((a0 mu0 + a1 mu1) + a2 mu2); a and b times the
// centre's validity. Per output pixel: acc = box9(b), then
// acc += box9(a_c) * img_c for c = 0, 1, 2, and out = n * p - acc. Every
// sum runs over the 9 shifts row-major from 0, and the reciprocal is
// multiplied in, as in the TPU kernel: this is not K3's arithmetic (K3
// divides, sums its boxes separably and reads n and mu from planes), so
// the two agree to float32 rounding only. Entries outside [:H, :W] hold
// what the TPU kernel leaves there: partial sums of the windows next to
// the image, zeros further out, zeros in the last 4 columns.
//
// Bound on this card: device memory. The call must read the 10 static
// planes and p_pad and write one plane, 12 planes of Hp x Wp against
// K3's 15 of H x W; about 190 flops per pixel (the means are rebuilt in
// every call).
//
// Design: a block owns a 16 x 32 output tile. It loads valid, p and the
// image at halo 2 into shared memory (zero past the planes' edge), keeps
// valid * p beside them, computes n, a0, a1, a2, b on the centre grid
// (halo 1) with each centre's six factors read once from the planes, and
// takes the member boxes from shared memory. About 29 KB of static
// shared memory. The TPU kernel's (T + 8)-row DMA window, its semaphores
// and the store re-based to lane 0 do not cross over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 32;           // output tile
constexpr int LH = TH + 4, LW = TW + 4;   // loaded tile (halo 2)
constexpr int CH = TH + 2, CW = TW + 2;   // centre grid (halo 1)
constexpr int kThreads = 256;
constexpr int kStatic = 10;

__global__ void __launch_bounds__(kThreads)
matvec_recompute_kernel(const float* __restrict__ p_pad,
                        const float* __restrict__ stat, int Hp, int Wp,
                        int Ho, float* __restrict__ out) {
  __shared__ float s_v[LH][LW];
  __shared__ float s_p[LH][LW];
  __shared__ float s_vp[LH][LW];
  __shared__ float s_img[3][LH][LW];
  __shared__ float c_a[5][CH][CW];   // a0, a1, a2, b, n

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int64_t plane = (int64_t)Hp * Wp;
  const float* st = stat + (int64_t)b * kStatic * plane;
  const float* pb = p_pad + (int64_t)b * plane;

  // output pixel (y, x) lies at padded position (y + 2, x + 2)
  for (int i = threadIdx.x; i < LH * LW; i += kThreads) {
    const int ly = i / LW, lx = i % LW;
    const int py = y0 + ly, px = x0 + lx;
    const bool in = py < Hp && px < Wp;
    const int64_t g = (int64_t)py * Wp + px;
    const float v = in ? st[g] : 0.f;
    const float pv = in ? pb[g] : 0.f;
    s_v[ly][lx] = v;
    s_p[ly][lx] = pv;
    s_vp[ly][lx] = v * pv;
    s_img[0][ly][lx] = in ? st[1 * plane + g] : 0.f;
    s_img[1][ly][lx] = in ? st[2 * plane + g] : 0.f;
    s_img[2][ly][lx] = in ? st[3 * plane + g] : 0.f;
  }
  __syncthreads();

  // ---- pass 1: per-centre window stats and (a, b) ------------------------
  for (int i = threadIdx.x; i < CH * CW; i += kThreads) {
    const int cy = i / CW, cx = i % CW;
    const int ly = cy + 1, lx = cx + 1;
    const int py = y0 + ly, px = x0 + lx;

    float n = 0.f, pbar = 0.f, m0 = 0.f, m1 = 0.f, m2 = 0.f;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float v = s_v[ly + dy][lx + dx];
        n = n + v;
        m0 = m0 + v * s_img[0][ly + dy][lx + dx];
        m1 = m1 + v * s_img[1][ly + dy][lx + dx];
        m2 = m2 + v * s_img[2][ly + dy][lx + dx];
        pbar = pbar + s_vp[ly + dy][lx + dx];
      }
    const float ninv = 1.f / fmaxf(n, 1.f);
    const float mu0 = m0 * ninv, mu1 = m1 * ninv, mu2 = m2 * ninv;
    pbar = pbar * ninv;

    float cov0 = 0.f, cov1 = 0.f, cov2 = 0.f;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float w = s_vp[ly + dy][lx + dx];
        cov0 = cov0 + (s_img[0][ly + dy][lx + dx] - mu0) * w;
        cov1 = cov1 + (s_img[1][ly + dy][lx + dx] - mu1) * w;
        cov2 = cov2 + (s_img[2][ly + dy][lx + dx] - mu2) * w;
      }

    float f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (py < Hp && px < Wp) {
      const int64_t g = (int64_t)py * Wp + px;
      for (int k = 0; k < 6; ++k) f[k] = st[(4 + k) * plane + g];
    }
    const float i1 = f[0], i2 = f[1], i3 = f[2];
    const float l21 = f[3], l31 = f[4], l32 = f[5];
    const float bq = l21 * l32 - l31;
    const float c0 = cov0 * ninv, c1 = cov1 * ninv, c2 = cov2 * ninv;
    const float t1 = c1 - l21 * c0;
    const float t2 = bq * c0 - l32 * c1 + c2;
    const float w0 = i1 * c0, w1 = i2 * t1, w2 = i3 * t2;
    const float a0 = w0 - l21 * w1 + bq * w2;
    const float a1 = w1 - l32 * w2;
    const float a2 = w2;
    const float bsc = pbar - ((a0 * mu0 + a1 * mu1) + a2 * mu2);

    const float vc = s_v[ly][lx];   // only real windows contribute
    c_a[0][cy][cx] = a0 * vc;
    c_a[1][cy][cx] = a1 * vc;
    c_a[2][cy][cx] = a2 * vc;
    c_a[3][cy][cx] = bsc * vc;
    c_a[4][cy][cx] = n;
  }
  __syncthreads();

  // ---- pass 2: box-sum (a, b) over the covering windows ------------------
  for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
    const int oy = i / TW, ox = i % TW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= Ho || gx >= Wp) continue;
    float q = 0.f;
    if (gx < Wp - 4) {
      float box[4];
      for (int k = 0; k < 4; ++k) {
        float s = 0.f;
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) s = s + c_a[k][oy + r][ox + c];
        box[k] = s;
      }
      float acc = box[3];
      acc = acc + box[0] * s_img[0][oy + 2][ox + 2];
      acc = acc + box[1] * s_img[1][oy + 2][ox + 2];
      acc = acc + box[2] * s_img[2][oy + 2][ox + 2];
      q = c_a[4][oy + 1][ox + 1] * s_p[oy + 2][ox + 2] - acc;
    }
    out[((int64_t)b * Ho + gy) * Wp + gx] = q;
  }
}

}  // namespace

extern "C" int iseg_matvec_recompute(const void* p_pad, const void* stat,
                                     int batch, int Hp, int Wp, int Ho,
                                     void* out, void* stream) {
  if (batch > 65535 || Hp <= 4 || Wp <= 4 || Ho < Hp - 4)
    return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    dim3 grid((Wp + TW - 1) / TW, (Ho + TH - 1) / TH, batch);
    matvec_recompute_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p_pad), static_cast<const float*>(stat), Hp,
        Wp, Ho, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
