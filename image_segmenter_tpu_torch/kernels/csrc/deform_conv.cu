// The modulated deformable convolution (DCNv2) of BiRefNet's decoder:
// for every output pixel and each of its k^2 taps, the 64 input channels
// sampled bilinearly at the tap's offset position and scaled by the tap's
// modulator, then multiplied by the (256, k^2 * 64) weight; a bias and a
// ReLU after (the branch's BatchNorm folded into weight and bias).
//
// Replaces no TPU kernel: the JAX package has no BiRefNet. It was added
// because no library here computes a deformable convolution, and the
// plain alternative materialises the (B, 64 k^2, H W) operand of samples:
// 1.6 GB in bfloat16 for the 7 x 7 branch at 4 x 256 x 256. Here the
// operand never leaves the chip: each tap's samples go to shared memory
// and straight into the tensor cores.
//
// Bound on this card: the tensor cores for k = 7 and 3 (the 7 x 7 branch
// at 4 x 256 x 256 is 421 GFLOP against 322 MB of input, offsets,
// modulators, weights and output: 0.43 ms at 989 TFLOP/s, 0.10 ms at
// 3.35 TB/s), the memory for k = 1. The sampling is the other cost: four
// gathers and four multiply-adds a channel a tap, 1.35 G samples a
// BiRefNet call.
//
// A block takes BM = 32 WM output pixels (consecutive in (B, H, W) order)
// and all 256 output channels, and walks the taps. For each tap it stages
// the weight's (256, 64) slice with cp.async and the (BM, 64) operand of
// samples, which its threads compute (four a pixel, 16 channels each, two
// 16-byte loads a neighbour from the NHWC input), in two buffers, so that
// the next tap's copies and gathers overlap this tap's products. Warps are
// WM x 4, each 32 pixels x 64 channels, mma.sync m16n8k16 from ldmatrix
// fragments; rows in shared memory are padded by 8 elements against bank
// conflicts. The sums go through shared memory to 16-byte rows of the
// NHWC output, which may be a channel slice of a wider tensor (the branch
// concatenation).
//
// Arithmetic, as torchvision's deform_conv2d: the position y - p + i + dy
// in float32; zero where it is at or below -1 or at or above the size on
// either axis; else the corners' weights (1 - ly)(1 - lx), (1 - ly) lx,
// ly (1 - lx), ly lx against the four neighbours (zero outside), summed
// in that order, times the modulator, each step rounded in float32 (the
// library builds with --fmad=false), and the product rounded to bfloat16:
// the plain version, kernels/deform_conv.deform_conv_plain, makes the same
// operand bit for bit. The product with the weight sums in float32 in the
// tensor cores' order; the bias, the ReLU and the rounding of the result
// to bfloat16 come after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 64;     // input channels
constexpr int BN = 256;   // output channels
constexpr int LD = C + 8;  // a staged row, padded
constexpr int LDO = BN + 8;  // a row of the output tile, padded

struct Params {
  const bf16* x;       // (B, H, W, 64)
  const float* off;    // (B, H, W, 2 k^2)
  const float* mask;   // (B, H, W, k^2)
  const bf16* wt;      // (256, k^2, 64)
  const float* bias;   // (256,) or null
  bf16* out;           // (B, H, W) pixels ldo apart
  int64_t ldo;
  int npix, h, w, k, relu;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

// The weight's slice of tap t, (256, 64), into dst: 2048 16-byte pieces.
template <int THREADS>
__device__ __forceinline__ void load_weight(const Params& p, int t, int k2,
                                            bf16* dst, int tid) {
#pragma unroll
  for (int q = tid; q < BN * C / 8; q += THREADS) {
    const int n = q >> 3, piece = q & 7;
    cp_async16(smem_addr(dst + n * LD + piece * 8),
               p.wt + (static_cast<int64_t>(n) * k2 + t) * C + piece * 8);
  }
}

// A thread's 16 channels of its pixel's sample at tap t = (i, j), times
// the modulator and rounded to bfloat16, into dst.
__device__ __forceinline__ void sample(const Params& p, int t, int k2,
                                       int64_t pix, int b, int py, int px,
                                       int c0, bf16* dst) {
  uint4 res[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (pix < p.npix) {
    const int i = t / p.k, j = t - i * p.k, pad = p.k >> 1;
    const float dy = __ldg(p.off + pix * 2 * k2 + 2 * t);
    const float dx = __ldg(p.off + pix * 2 * k2 + 2 * t + 1);
    const float m = __ldg(p.mask + pix * k2 + t);
    const float y = static_cast<float>(py - pad + i) + dy;
    const float x = static_cast<float>(px - pad + j) + dx;
    if (y > -1.0f && y < static_cast<float>(p.h) && x > -1.0f &&
        x < static_cast<float>(p.w)) {
      const float fy = floorf(y), fx = floorf(x);
      const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
      const float ly = y - fy, lx = x - fx;
      const float hy = 1.0f - ly, hx = 1.0f - lx;
      const float wt[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
      const bf16* base = p.x + static_cast<int64_t>(b) * p.h * p.w * C + c0;
      float acc[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int yy = y0 + (q >> 1), xx = x0 + (q & 1);
        uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
        if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w) {
          const uint4* src = reinterpret_cast<const uint4*>(
              base + (static_cast<int64_t>(yy) * p.w + xx) * C);
          v0 = __ldg(src);
          v1 = __ldg(src + 1);
        }
        float f0[8], f1[8];
        unpack8(v0, f0);
        unpack8(v1, f1);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float a = wt[q] * f0[c], b2 = wt[q] * f1[c];
          acc[c] = q == 0 ? a : acc[c] + a;
          acc[c + 8] = q == 0 ? b2 : acc[c + 8] + b2;
        }
      }
      unsigned r[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        r[c] = pack(m * acc[2 * c], m * acc[2 * c + 1]);
      res[0] = make_uint4(r[0], r[1], r[2], r[3]);
      res[1] = make_uint4(r[4], r[5], r[6], r[7]);
    }
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = res[0];
  d[1] = res[1];
}

// WM warps along the pixels, 4 along the channels; two blocks an SM.
template <int WM>
__global__ void __launch_bounds__(128 * WM, 2)
deform_conv_kernel(const Params p) {
  constexpr int BM = 32 * WM;
  constexpr int THREADS = 128 * WM;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // two (BM, LD) buffers
  bf16* sW = sA + 2 * BM * LD;               // two (BN, LD) buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tq = lane & 3;   // the mma fragments' row, pair
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix, its row
  const int k2 = p.k * p.k;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;

  // the thread's pixel and channels for the sampling
  const int pl = tid >> 2, c0 = (tid & 3) * 16;
  const int64_t pix = m0 + pl;
  const int hw = p.h * p.w;
  const int b = static_cast<int>(pix / hw);
  const int rem = static_cast<int>(pix - static_cast<int64_t>(b) * hw);
  const int py = rem / p.w, px = rem - py * p.w;

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.0f;

  load_weight<THREADS>(p, 0, k2, sW, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  sample(p, 0, k2, pix, b, py, px, c0, sA + pl * LD + c0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the lane's ldmatrix rows of the A and W buffers
  const unsigned a_lane =
      smem_addr(sA + (wm * 32 + (mi & 1) * 8 + ri) * LD + (mi >> 1) * 8);
  const unsigned w_lane =
      smem_addr(sW + (wn * 64 + (mi >> 1) * 8 + ri) * LD + (mi & 1) * 8);

  for (int t = 0; t < k2; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t + 1 < k2) {
      load_weight<THREADS>(p, t + 1, k2, sW + nxt * BN * LD, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      sample(p, t + 1, k2, pix, b, py, px, c0,
             sA + nxt * BM * LD + pl * LD + c0);
    }
    const unsigned at = a_lane + cur * BM * LD * 2;
    const unsigned wt = w_lane + cur * BN * LD * 2;
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      unsigned af[2][4];
      ldsm_x4(af[0], at + ks * 32);
      ldsm_x4(af[1], at + (16 * LD + ks * 16) * 2);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        unsigned wf[4];
        ldsm_x4(wf, wt + (pp * 16 * LD + ks * 16) * 2);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          mma(acc[a][2 * pp], af[a], wf[0], wf[1]);
          mma(acc[a][2 * pp + 1], af[a], wf[2], wf[3]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  // the epilogue: bias, ReLU, bfloat16, through shared memory (over the
  // weight buffers, free after the last sync) to 16-byte output rows
  bf16* sO = sW;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = wn * 64 + n * 8 + tq * 2;
    const float b0 = p.bias ? __ldg(p.bias + col) : 0.0f;
    const float b1 = p.bias ? __ldg(p.bias + col + 1) : 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v0 = acc[a][n][2 * r] + b0, v1 = acc[a][n][2 * r + 1] + b1;
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const int row = wm * 32 + a * 16 + g + 8 * r;
        *reinterpret_cast<unsigned*>(sO + row * LDO + col) = pack(v0, v1);
      }
  }
  __syncthreads();
#pragma unroll
  for (int q = tid; q < BM * BN / 8; q += THREADS) {
    const int row = q / (BN / 8), piece = q - row * (BN / 8);
    const int64_t px2 = m0 + row;
    if (px2 < p.npix)
      *reinterpret_cast<uint4*>(p.out + px2 * p.ldo + piece * 8) =
          *reinterpret_cast<const uint4*>(sO + row * LDO + piece * 8);
  }
}

template <int WM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 32 * WM;
  const size_t smem = sizeof(bf16) * 2 * (BM + BN) * LD;
  static_assert(sizeof(bf16) * 2 * BN * LD >= sizeof(bf16) * BM * LDO,
                "the output tile fits the weight buffers");
  auto kernel = deform_conv_kernel<WM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (p.npix + BM - 1) / BM;
  kernel<<<blocks, 128 * WM, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, 64) bfloat16; offset (B, H, W, 2 k^2) and mask (B, H, W, k^2)
// float32; weight (256, k, k, 64) bfloat16; bias (256,) float32 or null;
// all contiguous. out: (B, H, W) pixels of 256 bfloat16 channels, ldo
// elements apart (a multiple of 8), 16-byte aligned.
extern "C" int iseg_deform_conv(const void* x, const void* offset,
                                const void* mask, const void* weight,
                                const void* bias, int relu, int batch, int h,
                                int w, int k, void* out, int64_t ldo,
                                void* stream) {
  if (k < 1 || k % 2 == 0 || h < 1 || w < 1 || batch < 1 || ldo < BN ||
      ldo % 8)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.off = static_cast<const float*>(offset);
  p.mask = static_cast<const float*>(mask);
  p.wt = static_cast<const bf16*>(weight);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.ldo = ldo;
  p.npix = batch * h * w;
  p.h = h;
  p.w = w;
  p.k = k;
  p.relu = relu;
  return launch<2>(p, static_cast<cudaStream_t>(stream));
}
