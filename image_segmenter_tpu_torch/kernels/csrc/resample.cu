// RS: a u8 resize, out = W_y @ img @ W_x^T for each image and channel,
// summing only each output's band of taps.
//
// Replaces no TPU kernel: the JAX package leaves its resizes to XLA's dot
// over dense (dst, src) weight matrices. Run that way on this card, a 4K
// batch's resizes were float64 GEMMs of some 400 GFLOP a call, at the
// card's float64 peak, with a float64 copy of the batch and casts around
// them; almost every multiply-add was by a zero weight.
//
// Bound on this card: the float64 pipe, then device memory. A 4 x 2160 x
// 3840 batch's five resizes read some 0.27 GB of u8 and write 0.07 GB
// (0.1 ms at 3.35 TB/s) and take about 1.2 G float64 multiply-adds over
// the nonzero taps (0.07 ms at 34 TFLOP/s). The design keeps every
// float64 value out of device memory and shares each source byte's load
// and conversion among the output rows whose bands hold it. A block owns
// a tile of ty output rows (up to 32) by tx output columns (all channels)
// of one image. Its rows pass gives each thread a group of kRows output
// rows and kVec neighbouring bytes of the tile's source column window at
// a time: the thread walks the source rows of the group's bands once,
// kUnroll loads in flight, converts each byte to float64 once and adds it
// into the sum of every row of the group whose band holds that source
// row (kRows x kVec sums in registers), and writes the sums to shared
// memory. The weights of every row of the group are loaded at each source
// row, from clamped indices, so that the loads issue together ahead of
// the uniform branches. The columns pass gives each thread one output
// column of one channel, a group of rows at a time, and writes u8 in the
// dense contraction's layout (channel-planar rows). The wrapper
// (kernels/resample.py) makes the tile as wide as lets a group's sums fit
// 64 KB (three blocks an SM), then as tall as fits. A thread a sum reading
// a byte a tap waited on its loads: 2.29 ms for U2-Netp's five resizes of
// a 4K batch against 0.11 ms of bound; register groups of 8 rows left two
// blocks an SM and took 1.48 ms; this design about 0.64 ms (H100 80GB
// HBM3, 700 W).
//
// Bits: each output is ops/resize.resize_u8's arithmetic. The rows pass
// sums float32 weight x u8 value in ascending source index; such a product
// has at most 32 significant bits, so it is exact in float64 and a fused
// multiply-add rounds where a product and a sum would: `fma` there halves
// the pipe's work and changes no bit. The columns pass's products are not
// exact, so it multiplies and adds apart (`--fmad=false`, and the
// intrinsics say so). The sum rounds once to float32, then floor(x +
// 0.5f) in float32, clamped to 0..255. The dense GEMM sums the same terms
// in another order (and adds zeros), which rounds to the same float32 but
// for a tie at float64 precision: ops/resize.py's rounding argument.
// tests/test_torch_ops.py holds a numpy twin of this arithmetic to the
// dense bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // resident blocks an SM the registers allow
constexpr int kRows = 4;     // output rows a thread sums at once (GROUP)
constexpr int kVec = 4;      // bytes a load where the rows are aligned to it
                             // (else 1)
constexpr int kUnroll = 8;   // source rows whose loads a thread has in flight
constexpr int kFar = 0x3fffffff;  // a band start no source row reaches
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's most (MAX_TILE_BYTES)
constexpr int kMaxDevices = 64;

struct Args {
  const uint8_t* x;   // (B, H, W, C) u8
  const int* ys;      // (dh,) first source row of each output row's band
  const double* wy;   // (dh, ky) its taps: float32 values held as float64
  const int* xs;      // (dw,) first source column of each output column's
  const double* wx;   // (dw, kx)
  uint8_t* out;       // (B, dh, C, dw) u8: channel-planar rows
  int64_t h, pitch;   // source rows, bytes a source row (W C)
  int c, dh, dw, ky, kx, ty, tx;
};

// v exactly as a double, on the float64 pipe: the bits of 2^52 + v carry v
// in the low mantissa, and subtracting 2^52 is exact
__device__ __forceinline__ double u8_to_f64(unsigned v) {
  return __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(v)),
                   4503599627370496.0);
}

template <int VEC>
__device__ __forceinline__ unsigned load(const uint8_t* p) {
  if (VEC == 4) return __ldg(reinterpret_cast<const unsigned*>(p));
  return __ldg(p);
}

// source row r's VEC bytes (`word`) into the sums of the output rows whose
// bands hold r. Every row's weight is loaded (from a clamped index, so the
// loads need no branch and issue together); the band offsets are uniform
// over the block, so the branches around the multiply-adds are too
template <int VEC>
__device__ __forceinline__ void accumulate(double (&acc)[kRows][VEC],
                                           const int (&ys)[kRows],
                                           const double* wy, int ky, int ny,
                                           int r, unsigned word) {
  double v[VEC], w[kRows];
#pragma unroll
  for (int u = 0; u < VEC; ++u)
    v[u] = u8_to_f64(VEC == 1 ? word : __byte_perm(word, 0, 0x4440 + u));
#pragma unroll
  for (int t = 0; t < kRows; ++t)
    w[t] = __ldg(wy + min(t, ny - 1) * ky + min(max(r - ys[t], 0), ky - 1));
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    if (static_cast<unsigned>(r - ys[t]) < static_cast<unsigned>(ky)) {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        acc[t][u] = __fma_rn(w[t], v[u], acc[t][u]);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resample_kernel(const Args a) {
  extern __shared__ double sums[];  // (ny, row) float64 row sums
  const int oy0 = blockIdx.y * a.ty, ox0 = blockIdx.x * a.tx;
  const int ny = min(a.ty, a.dh - oy0), nx = min(a.tx, a.dw - ox0);
  const int c = a.c;
  // the tile's source window in bytes of a row, from a multiple of VEC:
  // the bands' starts never decrease
  const int b0 = (__ldg(a.xs + ox0) * c) & ~(VEC - 1);
  const int b1 =
      ((__ldg(a.xs + ox0 + nx - 1) + a.kx) * c + VEC - 1) & ~(VEC - 1);
  const int row = b1 - b0, vecs = row / VEC;
  const int groups = (ny + kRows - 1) / kRows;  // of kRows output rows
  const uint8_t* img =
      a.x + static_cast<int64_t>(blockIdx.z) * a.h * a.pitch + b0;

  // rows pass: sums[t][j] = sum_k wy[oy0 + t][k] x[ys[oy0 + t] + k][b0 + j],
  // a thread a group of rows and VEC bytes at a time
  for (int i = threadIdx.x; i < groups * vecs; i += kThreads) {
    const int g = i / vecs, j = (i - g * vecs) * VEC;
    const int t0 = g * kRows, nt = min(kRows, ny - t0);
    int ys[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      ys[t] = t < nt ? __ldg(a.ys + oy0 + t0 + t) : kFar;
    const int r0 = ys[0], r1 = __ldg(a.ys + oy0 + t0 + nt - 1) + a.ky;
    const double* wy = a.wy + static_cast<int64_t>(oy0 + t0) * a.ky;
    double acc[kRows][VEC];
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[t][u] = 0.0;
    const uint8_t* p = img + r0 * a.pitch + j;
    int r = r0;
    for (; r + kUnroll <= r1; r += kUnroll, p += kUnroll * a.pitch) {
      unsigned word[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) word[q] = load<VEC>(p + q * a.pitch);
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        accumulate<VEC>(acc, ys, wy, a.ky, nt, r + q, word[q]);
    }
    for (; r < r1; ++r, p += a.pitch)
      accumulate<VEC>(acc, ys, wy, a.ky, nt, r, load<VEC>(p));
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      if (t < nt)
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          sums[(t0 + t) * row + j + u] = acc[t][u];
  }
  __syncthreads();

  // columns pass: a thread an output column of one channel, a group of
  // rows at a time; the output is channel-planar a row, (B, dh, C, dw), as
  // the dense contraction leaves it, so neighbouring threads write
  // neighbouring bytes of a channel's row
  const int64_t plane = a.dw, opitch = plane * c;
  uint8_t* dst = a.out +
      (static_cast<int64_t>(blockIdx.z) * a.dh + oy0) * opitch + ox0;
  for (int j = threadIdx.x; j < nx * c; j += kThreads) {
    const int ch = j / nx, q = j - ch * nx;
    const int ox = ox0 + q;
    const double* col = sums + __ldg(a.xs + ox) * c + ch - b0;
    const double* w = a.wx + static_cast<int64_t>(ox) * a.kx;
    uint8_t* o = dst + ch * plane + q;
    for (int t0 = 0; t0 < ny; t0 += kRows) {
      const int nt = min(kRows, ny - t0);
      const double* s = col + t0 * row;
      double acc[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t] = 0.0;
      for (int k = 0; k < a.kx; ++k, s += c) {
        const double wk = __ldg(w + k);
#pragma unroll
        for (int t = 0; t < kRows; ++t)
          if (t < nt) acc[t] = __dadd_rn(acc[t], __dmul_rn(wk, s[t * row]));
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        if (t < nt) {
          const float y = floorf(__fadd_rn(__double2float_rn(acc[t]), 0.5f));
          o[(t0 + t) * opitch] =
              static_cast<uint8_t>(fminf(fmaxf(y, 0.0f), 255.0f));
        }
      }
    }
  }
}

template <int VEC>
int launch(const Args& a, int batch, int span, cudaStream_t stream) {
  // a row of sums: the span's bytes and up to VEC - 1 more at either end
  const size_t smem = static_cast<size_t>(a.ty) *
                      (static_cast<size_t>(span) * a.c + 2 * (VEC - 1)) *
                      sizeof(double);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    // allowed once a device, at the first launch that needs it: a shape's
    // first call is eager, so no CUDA graph is being captured then
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(resample_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev] = true;
    }
  }
  const dim3 grid((a.dw + a.tx - 1) / a.tx, (a.dh + a.ty - 1) / a.ty, batch);
  resample_kernel<VEC><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x u8 (B, H, W, C), B, H, W, C, ys int32 (dh,), wy f64 (dh, ky), dh, ky,
//  xs int32 (dw,), wx f64 (dw, kx), dw, kx, tile rows, tile columns, the
//  most source columns a tile reads, out u8 (B, dh, C, dw), stream)
extern "C" int iseg_resample_u8(const void* x, int batch, int h, int w, int c,
                                const void* ys, const void* wy, int dh, int ky,
                                const void* xs, const void* wx, int dw, int kx,
                                int ty, int tx, int span, void* out,
                                void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || c < 1 || dh < 1 ||
      dw < 1 || ky < 1 || ky > h || kx < 1 || kx > w || ty < 1 ||
      tx < 1 || span < kx || span > w ||
      (dh + ty - 1) / ty > 65535)
    return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.ys = static_cast<const int*>(ys);
  a.wy = static_cast<const double*>(wy);
  a.xs = static_cast<const int*>(xs);
  a.wx = static_cast<const double*>(wx);
  a.out = static_cast<uint8_t*>(out);
  a.h = h;
  a.pitch = static_cast<int64_t>(w) * c;
  a.c = c;
  a.dh = dh;
  a.dw = dw;
  a.ky = ky;
  a.kx = kx;
  a.ty = ty;
  a.tx = tx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // kVec bytes a load where every row starts on a multiple of kVec
  if (a.pitch % kVec == 0 && reinterpret_cast<uintptr_t>(x) % kVec == 0)
    return launch<kVec>(a, batch, span, s);
  return launch<1>(a, batch, span, s);
}
