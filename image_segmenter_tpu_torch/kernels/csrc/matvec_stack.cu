// K5: L @ p of the matting Laplacian, read from the untiled padded stack.
//
// Replaces image_segmenter_tpu/kernels/pallas_matvec.py:_kernel (the
// manual-DMA variant; math in _compute_tile, via matvec_planes). In: the
// (B, 13, Hp, Wp) zero-padded operand stack [n, mu_r, mu_g, mu_b, i1, i2,
// i3, l21, l31, l32, img_r, img_g, img_b] with the image at offset (2, 2),
// and p (B, H, W), unpadded. Out: (B, H, W).
//
// The arithmetic is K3's (csrc/matvec.cu), in the same order: separable
// box of p (columns then rows), shift-major covariance, division by
// max(n, 1), the packed-LDL solve, member boxes (columns then rows), and
// ((a0 r + a1 g) + a2 b) + b. What differs is where the operands come
// from. The stack is zero-padded by 2, so a window centred outside the
// image finds n = 0 and zero factors there: its a is 0 by arithmetic and
// its b is masked by n > 0, with no branch on the image border. Built
// without FMA contraction it gives K3's bits on the same operands.
//
// What does not cross over from the TPU kernel: the (T + 8)-row DMA window
// and its semaphores (a block loads its own 20 x 36 halo tile), the padded
// copy of p made before every call (p is read in place, zero outside the
// image), and the store re-based to lane 0 (the block writes (B, H, W)
// directly).
//
// Bound on this card: device memory. The call must read the 13 planes of
// the stack (Hp x Wp each, padding included: 13 * 584 * 1152 * 4 B per
// image at 576 x 1024) and p, and write one plane; about 100 flops per
// pixel. A block touches only the stack's rows and columns near the
// image, so most of the padding is in fact never read.
//
// Design: K3's. A block owns a 16 x 32 output tile; p and the image at
// halo 2 in shared memory, a0, a1, a2, b on the centre grid (halo 1) in
// shared memory with each centre's n, mu and factors read once from the
// stack; about 21 KB of static shared memory. Stack reads are checked
// against (Hp, Wp) because a tile's halo can pass the padded width when
// W + 4 is close to a multiple of 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 32;           // output tile
constexpr int LH = TH + 4, LW = TW + 4;   // loaded tile (halo 2)
constexpr int CH = TH + 2, CW = TW + 2;   // centre grid (halo 1)
constexpr int kThreads = 256;
constexpr int kPlanes = 13;

__global__ void __launch_bounds__(kThreads)
matvec_stack_kernel(const float* __restrict__ stack,
                    const float* __restrict__ p, int H, int W, int Hp, int Wp,
                    float* __restrict__ out) {
  __shared__ float s_p[LH][LW];
  __shared__ float s_img[3][LH][LW];
  __shared__ float c_a[4][CH][CW];   // a0, a1, a2, bb

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int64_t splane = (int64_t)Hp * Wp;
  const float* st = stack + (int64_t)b * kPlanes * splane;
  const float* pb = p + (int64_t)b * H * W;

  // image pixel (gy, gx) lies at stack position (gy + 2, gx + 2)
  for (int i = threadIdx.x; i < LH * LW; i += kThreads) {
    const int ly = i / LW, lx = i % LW;
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    const int sy = y0 + ly, sx = x0 + lx;
    const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bool in_st = sy < Hp && sx < Wp;
    const int64_t g = (int64_t)sy * Wp + sx;
    s_p[ly][lx] = in_img ? pb[(int64_t)gy * W + gx] : 0.f;
    s_img[0][ly][lx] = in_st ? st[10 * splane + g] : 0.f;
    s_img[1][ly][lx] = in_st ? st[11 * splane + g] : 0.f;
    s_img[2][ly][lx] = in_st ? st[12 * splane + g] : 0.f;
  }
  __syncthreads();

  // ---- per-window a_k, b_k on the centre grid --------------------------
  for (int i = threadIdx.x; i < CH * CW; i += kThreads) {
    const int cy = i / CW, cx = i % CW;
    const int sy = y0 + 1 + cy, sx = x0 + 1 + cx;
    if (sy >= Hp || sx >= Wp) {
      c_a[0][cy][cx] = 0.f;
      c_a[1][cy][cx] = 0.f;
      c_a[2][cy][cx] = 0.f;
      c_a[3][cy][cx] = 0.f;
      continue;
    }
    const int ly = cy + 1, lx = cx + 1;
    const int64_t g = (int64_t)sy * Wp + sx;
    const float nk = st[g];
    const float mu0 = st[1 * splane + g], mu1 = st[2 * splane + g],
                mu2 = st[3 * splane + g];
    const float ki1 = st[4 * splane + g], ki2 = st[5 * splane + g],
                ki3 = st[6 * splane + g];
    const float kl21 = st[7 * splane + g], kl31 = st[8 * splane + g],
                kl32 = st[9 * splane + g];

    float rows[3];
    for (int r = 0; r < 3; ++r) {
      const float* pr = &s_p[ly - 1 + r][lx - 1];
      rows[r] = (pr[0] + pr[1]) + pr[2];
    }
    const float psum = (rows[0] + rows[1]) + rows[2];
    const float n_div = fmaxf(nk, 1.f);
    const float pbar = psum / n_div;

    float cov0 = 0.f, cov1 = 0.f, cov2 = 0.f;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float vp = s_p[ly + dy][lx + dx];
        cov0 += (s_img[0][ly + dy][lx + dx] - mu0) * vp;
        cov1 += (s_img[1][ly + dy][lx + dx] - mu1) * vp;
        cov2 += (s_img[2][ly + dy][lx + dx] - mu2) * vp;
      }
    const float bq = kl21 * kl32 - kl31;
    const float v0 = cov0 / n_div, v1 = cov1 / n_div, v2 = cov2 / n_div;
    const float t1 = v1 - kl21 * v0;
    const float t2 = bq * v0 - kl32 * v1 + v2;
    const float w0 = ki1 * v0, w1 = ki2 * t1, w2 = ki3 * t2;
    const float a0 = w0 - kl21 * w1 + bq * w2;
    const float a1 = w1 - kl32 * w2;
    const float a2 = w2;
    const float bb = pbar - ((a0 * mu0 + a1 * mu1) + a2 * mu2);
    c_a[0][cy][cx] = a0;
    c_a[1][cy][cx] = a1;
    c_a[2][cy][cx] = a2;
    c_a[3][cy][cx] = nk > 0.f ? bb : 0.f;
  }
  __syncthreads();

  // ---- member boxes and the output -------------------------------------
  for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
    const int oy = i / TW, ox = i % TW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    float box[4];
    for (int q = 0; q < 4; ++q) {
      float rs[3];
      for (int r = 0; r < 3; ++r) {
        const float* ar = &c_a[q][oy + r][ox];
        rs[r] = (ar[0] + ar[1]) + ar[2];
      }
      box[q] = (rs[0] + rs[1]) + rs[2];
    }
    const float cnt = st[(int64_t)(gy + 2) * Wp + gx + 2];
    const float pi = s_p[oy + 2][ox + 2];
    out[(int64_t)b * H * W + (int64_t)gy * W + gx] =
        cnt * pi - (((box[0] * s_img[0][oy + 2][ox + 2]
                      + box[1] * s_img[1][oy + 2][ox + 2])
                     + box[2] * s_img[2][oy + 2][ox + 2]) + box[3]);
  }
}

}  // namespace

extern "C" int iseg_matvec_stack(const void* stack, const void* p, int batch,
                                 int H, int W, int Hp, int Wp, void* out,
                                 void* stream) {
  if (batch > 65535 || Hp < H + 4 || Wp < W + 4)
    return (int)cudaErrorInvalidValue;
  if (batch > 0 && H > 0 && W > 0) {
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, batch);
    matvec_stack_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(stack), static_cast<const float*>(p), H, W,
        Hp, Wp, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
