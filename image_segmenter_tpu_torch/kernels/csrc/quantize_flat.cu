// K7: the nearest-palette map of K4 on four flat planes r, g, b, a.
//
// Replaces the pallas_call in bench/micro_quantize.py (quantize_map_flat,
// body image_segmenter_tpu/kernels/pallas_quantize.py:_kernel): the flat
// planar blocking the TPU study held against the native (H, W) blocks.
//
// Per pixel, K4's arithmetic exactly: squared distance
// (r-cr)^2 + (g-cg)^2 + (b-cb)^2 to each of the first k_real palette
// entries, first minimum by strict <, and the winning colour where
// alpha > 0 and (r+g+b) * (1/3) > thr, else 0. Every multiply and add is
// an explicitly rounded intrinsic, so the result is bit-equal to K4 and to
// the plain PyTorch version for any float palette.
//
// Bound on this card: K4's. 4 bytes read and 3 written per pixel against
// 16 x 9 + 8 operations per pixel: on paper the operations (about 75 us at
// 4 x 2160 x 3840) just ahead of the bytes (about 69 us).
//
// Design: what the study varies is the layout. The planes are contiguous
// bytes, so a thread takes 16 pixels with one 16-byte load per plane and
// writes them with one 16-byte store per plane: a warp moves whole 512-byte
// lines, where K4's threads pick 3-byte pixels out of an interleaved frame.
// The palette sits in shared memory and is read as a broadcast. (Carrying
// eight pixels through one palette loop, so that an entry is read once
// for the eight, measured slower, 0.44-0.46 ms against 0.40-0.43 ms at
// 4 x 2160 x 3840 on an H100 at 700 W: the palette reads are not what
// bounds the map.) The TPU's 256 x 128 blocks and zero padding do not
// cross over: the 16-byte path needs a row length that is a multiple of
// 16 and 16-byte aligned planes
// (every row of every plane then starts aligned); any other size or
// alignment takes the byte path, one pixel per thread and step, which has
// no tail to pad. The split of the interleaved frame into planes and the
// stack back are copies made by the wrapper in PyTorch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 256;

struct Pixel {
  uint8_t r, g, b;
};

__device__ __forceinline__ Pixel map_pixel(unsigned ri, unsigned gi,
                                           unsigned bi, unsigned ai,
                                           const float* pal, int k_use,
                                           float t) {
  const float r = (float)ri, g = (float)gi, bl = (float)bi;
  float best_d = INFINITY, br = 0.f, bg = 0.f, bb = 0.f;
  for (int k = 0; k < k_use; ++k) {
    const float cr = pal[3 * k], cg = pal[3 * k + 1], cb = pal[3 * k + 2];
    const float dr = __fsub_rn(r, cr);
    const float dg = __fsub_rn(g, cg);
    const float db = __fsub_rn(bl, cb);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)),
                              __fmul_rn(db, db));
    if (d < best_d) {
      best_d = d;
      br = cr;
      bg = cg;
      bb = cb;
    }
  }
  const float bright =
      __fmul_rn(__fadd_rn(__fadd_rn(r, g), bl), 1.0f / 3.0f);
  const bool fit = ai > 0 && bright > t;
  // float -> int32 truncates, int32 -> u8 wraps: the Pallas kernel's casts
  Pixel out;
  out.r = fit ? (uint8_t)(int)br : 0;
  out.g = fit ? (uint8_t)(int)bg : 0;
  out.b = fit ? (uint8_t)(int)bb : 0;
  return out;
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ void put_byte(uint4& v, int j, unsigned b) {
  const unsigned s = b << (8 * (j & 3));
  if (j < 4) v.x |= s;
  else if (j < 8) v.y |= s;
  else if (j < 12) v.z |= s;
  else v.w |= s;
}

// planes (3, B, hw) u8, alpha (B, hw) u8 -> out (3, B, hw) u8
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_flat_kernel(const uint8_t* __restrict__ planes,
                     const uint8_t* __restrict__ alpha,
                     const float* __restrict__ centers,
                     const float* __restrict__ thr, int batch, int64_t hw,
                     int k_max, int k_use, uint8_t* __restrict__ out) {
  __shared__ float pal[kMaxK * 3];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < k_use * 3; i += kThreads)
    pal[i] = centers[(int64_t)b * k_max * 3 + i];
  __syncthreads();
  const float t = thr[b];
  const int64_t plane = (int64_t)batch * hw;
  const int64_t row = (int64_t)b * hw;
  const uint8_t* pr = planes + row;
  const uint8_t* pg = planes + plane + row;
  const uint8_t* pb = planes + 2 * plane + row;
  const uint8_t* pa = alpha + row;
  uint8_t* qr = out + row;
  uint8_t* qg = out + plane + row;
  uint8_t* qb = out + 2 * plane + row;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  if constexpr (kVec) {
    const int64_t nvec = hw / 16;
    for (int64_t i = first; i < nvec; i += stride) {
      const uint4 vr = reinterpret_cast<const uint4*>(pr)[i];
      const uint4 vg = reinterpret_cast<const uint4*>(pg)[i];
      const uint4 vb = reinterpret_cast<const uint4*>(pb)[i];
      const uint4 va = reinterpret_cast<const uint4*>(pa)[i];
      uint4 orr = make_uint4(0, 0, 0, 0), og = orr, ob = orr;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const Pixel p = map_pixel(byte_of(vr, j), byte_of(vg, j),
                                  byte_of(vb, j), byte_of(va, j), pal, k_use,
                                  t);
        put_byte(orr, j, p.r);
        put_byte(og, j, p.g);
        put_byte(ob, j, p.b);
      }
      reinterpret_cast<uint4*>(qr)[i] = orr;
      reinterpret_cast<uint4*>(qg)[i] = og;
      reinterpret_cast<uint4*>(qb)[i] = ob;
    }
  } else {
    for (int64_t i = first; i < hw; i += stride) {
      const Pixel p = map_pixel(pr[i], pg[i], pb[i], pa[i], pal, k_use, t);
      qr[i] = p.r;
      qg[i] = p.g;
      qb[i] = p.b;
    }
  }
}

}  // namespace

extern "C" int iseg_quantize_flat(const void* planes, const void* alpha,
                                  const void* centers, const void* thr,
                                  int batch, int64_t hw, int k_max, int k_real,
                                  void* out, void* stream) {
  int k_use = k_real < k_max ? k_real : k_max;
  if (k_use < 0) k_use = 0;
  if (k_use > kMaxK || batch > 65535) return (int)cudaErrorInvalidValue;
  if (hw > 0 && batch > 0) {
    const bool vec = hw % 16 == 0 && (uintptr_t)planes % 16 == 0 &&
                     (uintptr_t)alpha % 16 == 0 && (uintptr_t)out % 16 == 0;
    // one step of the loop per thread where the grid allows it
    const int64_t items = vec ? hw / 16 : (hw + 3) / 4;
    int64_t blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 8192) blocks = 8192;
    dim3 grid((unsigned)blocks, (unsigned)batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto launch = vec ? quantize_flat_kernel<true> : quantize_flat_kernel<false>;
    launch<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(planes), static_cast<const uint8_t*>(alpha),
        static_cast<const float*>(centers), static_cast<const float*>(thr),
        batch, hw, k_max, k_use, static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}
