// The nearest-palette search shared by K4 (quantize.cu, the interleaved
// frame) and K7 (quantize_flat.cu, flat planes): the block's palette in
// shared memory, the two searches and the per-pixel output.
//
// Per pixel: squared distance (r-cr)^2 + (g-cg)^2 + (b-cb)^2 to each of
// the first k_use palette entries, first minimum by strict <, and the
// winning colour where alpha > 0 and (r+g+b) * (1/3) > thr, else 0.
// Bit-exact against the plain PyTorch versions for any float32 palette.
//
// Two paths, chosen per image by the block as it stages its palette
// (stage_palette), uniform over the block:
// - Whole-number palette (the main path: k-means centres rounded to u8).
//   With u8 pixels and centres that are integers in [0, 255] every
//   difference, product and sum is an integer below 3 * 255^2 < 2^24:
//   exact in float32 in any order, fused or not, and equal to the same
//   sum in int32. So the distance is taken in integers: the pixel packed
//   as four u8, s = dp4a(pixel, centre) = p . c, and one multiply-add
//   key = ck - 512 s with ck = (|c|^2 << 8) | k. The key is
//   (distance - |p|^2) * 256 + k, so its minimum over k is the smallest
//   distance and, among equals, the lowest index: what strict < in index
//   order gives. Three instructions an entry and pixel.
// - Any other palette: the separately rounded intrinsics, in the plain
//   version's order, carrying the winner's index instead of its three
//   channels.
// Either way the winner's colour is looked up once after the loop, from a
// table already taken through the kernel's casts (float -> int32
// truncates, int32 -> u8 wraps: the Pallas kernel's).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;

struct Palette {
  float f[kMaxK * 3];      // as given: the float paths
  int2 wk[kMaxK];          // whole-number: {r | g << 8 | b << 16, ck}
  uint32_t out[kMaxK + 1]; // colour of winner k as r | g << 8 | b << 16; 0
                           // from k_use on ("no winner" is index kMaxK)
};

// Stage the first k_use entries of one image's (k_max, 3) palette `c` in
// shared memory; every thread of the block calls it. Returns whether every
// entry is a whole number in [0, 255] (the same answer in every thread).
__device__ __forceinline__ bool stage_palette(Palette& pal,
                                              const float* __restrict__ c,
                                              int k_use) {
  const int tid = threadIdx.x, nt = blockDim.x;
  bool whole = true;
  for (int i = tid; i < k_use * 3; i += nt) {
    const float v = c[i];
    pal.f[i] = v;
    whole = whole && v >= 0.f && v <= 255.f && v == floorf(v);
  }
  whole = __syncthreads_and(whole) != 0;   // uniform over the block
  for (int k = tid; k <= kMaxK; k += nt) {
    uint32_t col = 0u;
    if (k < k_use) {
      const float cr = pal.f[3 * k], cg = pal.f[3 * k + 1], cb = pal.f[3 * k + 2];
      // float -> int32 truncates, int32 -> u8 wraps: the Pallas kernel's casts
      col = (uint32_t)(uint8_t)(int)cr | ((uint32_t)(uint8_t)(int)cg << 8)
            | ((uint32_t)(uint8_t)(int)cb << 16);
      if (whole) {
        const int r = (int)cr, g = (int)cg, bl = (int)cb;
        pal.wk[k] = make_int2(r | (g << 8) | (bl << 16),
                              ((r * r + g * g + bl * bl) << 8) | k);
      }
    }
    pal.out[k] = col;
  }
  __syncthreads();
  return whole;
}

// Index of the nearest entry for P pixels, each packed r | g << 8 | b << 16
// (the top byte is ignored).
template <int P>
__device__ __forceinline__ void nearest_dp4a(const Palette& pal, int k_use,
                                             const uint32_t (&pix)[P],
                                             int (&idx)[P]) {
  int best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) best[j] = INT_MAX;
#pragma unroll 4
  for (int k = 0; k < k_use; ++k) {
    const int2 e = pal.wk[k];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = (int)__dp4a(pix[j], (uint32_t)e.x, 0u);
      best[j] = min(best[j], e.y - 512 * s);
    }
  }
  // INT_MAX (no entry) gives 255, which is >= k_use only when k_use == 0
#pragma unroll
  for (int j = 0; j < P; ++j) idx[j] = best[j] & 0xFF;
}

template <int P>
__device__ __forceinline__ void nearest_float(const Palette& pal, int k_use,
                                              const uint32_t (&pix)[P],
                                              int (&idx)[P]) {
  float r[P], g[P], bl[P], best[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    r[j] = (float)(pix[j] & 0xFF);
    g[j] = (float)((pix[j] >> 8) & 0xFF);
    bl[j] = (float)((pix[j] >> 16) & 0xFF);
    best[j] = INFINITY;
    idx[j] = kMaxK;
  }
#pragma unroll 2
  for (int k = 0; k < k_use; ++k) {
    const float cr = pal.f[3 * k], cg = pal.f[3 * k + 1], cb = pal.f[3 * k + 2];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float dr = __fsub_rn(r[j], cr);
      const float dg = __fsub_rn(g[j], cg);
      const float db = __fsub_rn(bl[j], cb);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)), __fmul_rn(db, db));
      if (d < best[j]) {
        best[j] = d;
        idx[j] = k;
      }
    }
  }
}

// The output colour of P pixels: the winner's where the pixel is opaque
// and bright enough, else 0.
template <int P>
__device__ __forceinline__ void map_pixels(const Palette& pal, int k_use,
                                           bool whole, float thr,
                                           const uint32_t (&pix)[P],
                                           const bool (&opaque)[P],
                                           uint32_t (&col)[P]) {
  int idx[P];
  if (whole) nearest_dp4a<P>(pal, k_use, pix, idx);
  else nearest_float<P>(pal, k_use, pix, idx);
  const float third = 1.0f / 3.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    // r + g + b is exact in float32 in any order, so one integer sum
    const float sum = (float)__dp4a(pix[j], 0x00010101u, 0u);
    const bool fit = opaque[j] && __fmul_rn(sum, third) > thr;
    col[j] = fit ? pal.out[idx[j]] : 0u;
  }
}

}  // namespace
