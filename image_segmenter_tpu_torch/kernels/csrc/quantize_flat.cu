// K7: the nearest-palette map of K4 on four flat planes r, g, b, a.
//
// Replaces the pallas_call in bench/micro_quantize.py (quantize_map_flat,
// body image_segmenter_tpu/kernels/pallas_quantize.py:_kernel): the flat
// planar blocking the TPU study held against the native (H, W) blocks.
//
// Per pixel, K4's arithmetic exactly (palette_map.cuh): squared distance
// to each of the first k_real palette entries, first minimum by strict <,
// and the winning colour where alpha > 0 and (r+g+b) * (1/3) > thr, else
// 0. Bit-equal to K4 and to the plain PyTorch version for any float
// palette.
//
// Bound on this card: K4's. 4 bytes read and 3 written per pixel (232 MB
// at 4 x 2160 x 3840, 69 us of HBM time). A float palette, rounded where
// the plain version rounds, costs about 11 instructions a pixel and entry
// and the instructions set the time; a whole-number palette takes K4's
// integer keys, three an entry, and the bytes come close to setting it.
//
// Design: the planes are contiguous bytes, so a thread takes 16 pixels
// with one 16-byte load from each of r, g, b and a, packs each pixel as
// r | g << 8 | b << 16 with two __byte_perm a pair of pixels, runs K4's
// search (map_pixels) over groups of kGroup pixels, so that each palette
// read from shared memory serves the group, scatters the colour bytes back
// into three 16-byte words and stores one per plane: a warp moves whole
// 512-byte lines. The 16-byte path needs a row length that is a multiple
// of 16 and 16-byte aligned planes (every row of every plane then starts
// aligned); any other size or alignment takes the byte path, one pixel a
// thread and step through the same search. The grid is the wrapper's:
// for each image, blocks that stride over its pixels
// (kernels/quantize_flat.py, `grid_blocks`). The split of the interleaved
// frame into planes and the stack back are copies made by the wrapper in
// PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "palette_map.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;   // pixels a palette loop serves (4, 8 or 16)
static_assert(kGroup % 4 == 0 && 16 % kGroup == 0, "whole words a group");

// Pixels 4 w .. 4 w + 3 of a group from one word of each colour plane,
// each packed r | g << 8 | b << 16 (the top byte repeats r and is ignored).
template <int P>
__device__ __forceinline__ void pack4(uint32_t r, uint32_t g, uint32_t b,
                                      uint32_t (&pix)[P], int w) {
  const uint32_t lo = __byte_perm(r, g, 0x5140);  // r0 g0 r1 g1
  const uint32_t hi = __byte_perm(r, g, 0x7362);  // r2 g2 r3 g3
  pix[4 * w] = __byte_perm(lo, b, 0x0410);        // r0 g0 b0 .
  pix[4 * w + 1] = __byte_perm(lo, b, 0x0532);    // r1 g1 b1 .
  pix[4 * w + 2] = __byte_perm(hi, b, 0x0610);    // r2 g2 b2 .
  pix[4 * w + 3] = __byte_perm(hi, b, 0x0732);    // r3 g3 b3 .
}

// The inverse for output colours c = r | g << 8 | b << 16: one word of
// each plane for pixels 4 w .. 4 w + 3.
template <int P>
__device__ __forceinline__ void unpack4(const uint32_t (&c)[P], int w,
                                        uint32_t& r, uint32_t& g,
                                        uint32_t& b) {
  const uint32_t c0 = c[4 * w], c1 = c[4 * w + 1], c2 = c[4 * w + 2],
                 c3 = c[4 * w + 3];
  const uint32_t lo = __byte_perm(c0, c1, 0x5140);   // r0 r1 g0 g1
  const uint32_t hi = __byte_perm(c2, c3, 0x5140);   // r2 r3 g2 g3
  r = __byte_perm(lo, hi, 0x5410);
  g = __byte_perm(lo, hi, 0x7632);
  const uint32_t blo = __byte_perm(c0, c1, 0x7362);  // b0 b1 . .
  const uint32_t bhi = __byte_perm(c2, c3, 0x7362);  // b2 b3 . .
  b = __byte_perm(blo, bhi, 0x5410);
}

// planes (3, B, hw) u8, alpha (B, hw) u8 -> out (3, B, hw) u8
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_flat_kernel(const uint8_t* __restrict__ planes,
                     const uint8_t* __restrict__ alpha,
                     const float* __restrict__ centers,
                     const float* __restrict__ thr, int batch, int64_t hw,
                     int k_max, int k_use, uint8_t* __restrict__ out) {
  __shared__ Palette pal;
  const int b = blockIdx.y;
  const bool whole =
      stage_palette(pal, centers + (int64_t)b * k_max * 3, k_use);
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
    constexpr int kWords = kGroup / 4;   // words of a plane a group takes
    const int64_t nvec = hw / 16;
    for (int64_t i = first; i < nvec; i += stride) {
      const uint4 vr = reinterpret_cast<const uint4*>(pr)[i];
      const uint4 vg = reinterpret_cast<const uint4*>(pg)[i];
      const uint4 vb = reinterpret_cast<const uint4*>(pb)[i];
      const uint4 va = reinterpret_cast<const uint4*>(pa)[i];
      const uint32_t wr[4] = {vr.x, vr.y, vr.z, vr.w};
      const uint32_t wg[4] = {vg.x, vg.y, vg.z, vg.w};
      const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
      uint32_t orr[4], og[4], ob[4];
#pragma unroll
      for (int grp = 0; grp < 16 / kGroup; ++grp) {
        uint32_t pix[kGroup], col[kGroup];
        bool opaque[kGroup];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int word = grp * kWords + w;
          pack4<kGroup>(wr[word], wg[word], wb[word], pix, w);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            opaque[4 * w + j] = ((wa[word] >> (8 * j)) & 0xFFu) != 0;
        }
        map_pixels<kGroup>(pal, k_use, whole, t, pix, opaque, col);
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int word = grp * kWords + w;
          unpack4<kGroup>(col, w, orr[word], og[word], ob[word]);
        }
      }
      reinterpret_cast<uint4*>(qr)[i] =
          make_uint4(orr[0], orr[1], orr[2], orr[3]);
      reinterpret_cast<uint4*>(qg)[i] = make_uint4(og[0], og[1], og[2], og[3]);
      reinterpret_cast<uint4*>(qb)[i] = make_uint4(ob[0], ob[1], ob[2], ob[3]);
    }
  } else {
    for (int64_t i = first; i < hw; i += stride) {
      const uint32_t pix[1] = {(uint32_t)pr[i] | ((uint32_t)pg[i] << 8)
                               | ((uint32_t)pb[i] << 16)};
      const bool opaque[1] = {pa[i] != 0};
      uint32_t col[1];
      map_pixels<1>(pal, k_use, whole, t, pix, opaque, col);
      qr[i] = (uint8_t)col[0];
      qg[i] = (uint8_t)(col[0] >> 8);
      qb[i] = (uint8_t)(col[0] >> 16);
    }
  }
}

}  // namespace

// blocks: blocks a launch gives each image (>= 1); they stride over its
// pixels.
extern "C" int iseg_quantize_flat(const void* planes, const void* alpha,
                                  const void* centers, const void* thr,
                                  int batch, int64_t hw, int k_max, int k_real,
                                  int blocks, void* out, void* stream) {
  int k_use = k_real < k_max ? k_real : k_max;
  if (k_use < 0) k_use = 0;
  if (k_use > kMaxK || batch > 65535 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (hw > 0 && batch > 0) {
    const bool vec = hw % 16 == 0 && (uintptr_t)planes % 16 == 0 &&
                     (uintptr_t)alpha % 16 == 0 && (uintptr_t)out % 16 == 0;
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
