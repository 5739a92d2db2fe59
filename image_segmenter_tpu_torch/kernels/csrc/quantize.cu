// K4: fused nearest-palette map with black-filter and alpha masking.
//
// Replaces image_segmenter_tpu/kernels/pallas_quantize.py:_kernel (via
// quantize_map).
//
// Per pixel: squared distance (r-cr)^2 + (g-cg)^2 + (b-cb)^2 to each of
// the first k_real palette entries, first minimum by strict <, and the
// winning colour where alpha > 0 and (r+g+b) * (1/3) > thr, else 0.
// Bit-exact against the plain PyTorch version for any float32 palette.
//
// Bound on this card: the function moves 3 + 1 bytes in and 3 out per
// pixel (232 MB at 4 x 2160 x 3840, 69 us of HBM time). With an arbitrary
// float palette every subtraction, product and sum must round where the
// plain version rounds, so none may fuse: about 11 instructions a pixel
// and palette entry, and the instructions, not the bytes, set the time
// (0.27 ms at k = 16). On a whole-number palette the integer path needs
// three, and the kernel comes down to what its loads and stores
// take (0.09 ms with no palette entry at all, 0.11 ms at k = 16).
//
// Design: the two paths of palette_map.cuh (integer keys for a
// whole-number palette, the separately rounded float path for any other),
// chosen per image by the block as it stages its palette.
// The interleaved (B, H*W, 3) frame is read as it lies. Where H*W is a
// multiple of 4 and the pointers are word-aligned a thread takes 4 pixels
// as three 32-bit words of RGB and one of alpha, shares each palette read
// between them and writes three words; any other size goes pixel by pixel
// through the same two paths.

#include <cuda_runtime.h>
#include <stdint.h>

#include "palette_map.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;  // grid-stride blocks a launch asks for

template <bool WORDS>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const uint8_t* __restrict__ rgb,
                const uint8_t* __restrict__ alpha,
                const float* __restrict__ centers,
                const float* __restrict__ thr, int64_t hw, int k_max,
                int k_use, uint8_t* __restrict__ out) {
  __shared__ Palette pal;
  const int b = blockIdx.y;

  const bool whole =
      stage_palette(pal, centers + (int64_t)b * k_max * 3, k_use);

  const float t = thr[b];
  const uint8_t* src = rgb + (int64_t)b * hw * 3;
  const uint8_t* a = alpha + (int64_t)b * hw;
  uint8_t* dst = out + (int64_t)b * hw * 3;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * kThreads;

  if (WORDS) {
    // 4 pixels a thread: w0 = r0 g0 b0 r1, w1 = g1 b1 r2 g2, w2 = b2 r3 g3 b3
    const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
    uint32_t* dst32 = reinterpret_cast<uint32_t*>(dst);
    for (int64_t q = first; q < hw / 4; q += step) {
      const uint32_t w0 = src32[3 * q], w1 = src32[3 * q + 1],
                     w2 = src32[3 * q + 2];
      const uint32_t aw = a32[q];
      const uint32_t pix[4] = {w0, __byte_perm(w0, w1, 0x0543),
                               __byte_perm(w1, w2, 0x0432), w2 >> 8};
      const bool opaque[4] = {(aw & 0xFFu) != 0, (aw & 0xFF00u) != 0,
                              (aw & 0xFF0000u) != 0, (aw & 0xFF000000u) != 0};
      uint32_t col[4];
      map_pixels<4>(pal, k_use, whole, t, pix, opaque, col);
      dst32[3 * q] = __byte_perm(col[0], col[1], 0x4210);
      dst32[3 * q + 1] = __byte_perm(col[1], col[2], 0x5421);
      dst32[3 * q + 2] = __byte_perm(col[2], col[3], 0x6542);
    }
  } else {
    for (int64_t p = first; p < hw; p += step) {
      const uint32_t pix[1] = {(uint32_t)src[3 * p]
                               | ((uint32_t)src[3 * p + 1] << 8)
                               | ((uint32_t)src[3 * p + 2] << 16)};
      const bool opaque[1] = {a[p] != 0};
      uint32_t col[1];
      map_pixels<1>(pal, k_use, whole, t, pix, opaque, col);
      dst[3 * p] = (uint8_t)col[0];
      dst[3 * p + 1] = (uint8_t)(col[0] >> 8);
      dst[3 * p + 2] = (uint8_t)(col[0] >> 16);
    }
  }
}

}  // namespace

extern "C" int iseg_quantize(const void* rgb, const void* alpha,
                             const void* centers, const void* thr, int batch,
                             int64_t hw, int k_max, int k_real, void* out,
                             void* stream) {
  int k_use = k_real < k_max ? k_real : k_max;
  if (k_use < 0) k_use = 0;
  if (k_use > kMaxK || batch > 65535) return (int)cudaErrorInvalidValue;
  if (hw > 0 && batch > 0) {
    int dev = 0, sms = 0;   // of the current device, asked every launch
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const bool words =
        hw % 4 == 0
        && ((uintptr_t)rgb | (uintptr_t)alpha | (uintptr_t)out) % 4 == 0;
    const int64_t items = words ? hw / 4 : hw;
    int64_t blocks = (items + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)(sms * kBlocksPerSm + batch - 1) / batch;
    if (blocks > cap) blocks = cap;
    dim3 grid((unsigned)blocks, (unsigned)batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (words)
      quantize_kernel<true><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(rgb), static_cast<const uint8_t*>(alpha),
          static_cast<const float*>(centers), static_cast<const float*>(thr),
          hw, k_max, k_use, static_cast<uint8_t*>(out));
    else
      quantize_kernel<false><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(rgb), static_cast<const uint8_t*>(alpha),
          static_cast<const float*>(centers), static_cast<const float*>(thr),
          hw, k_max, k_use, static_cast<uint8_t*>(out));
  }
  return (int)cudaGetLastError();
}
