// The matting CG's iteration outside K3: the vector algebra, the masks,
// the Jacobi preconditioner, the four float64 sums and the per-image
// scalars of solvers/matting.CGLoop._body and of the masks of its `step`,
// as three kernels that run after K3 in every iteration.
//
// Replaces no TPU kernel: the JAX package leaves the CG's update to XLA,
// which fuses it around its Pallas matvec. Run as PyTorch operations, the
// iteration was some 70 launches of elementwise and reduction kernels
// (0.35 ms of device time at 4 x 576 x 1024 beside K3's 0.08 ms), most of
// them reading and writing whole fields that a fused pass keeps in
// registers.
//
// Bound on this card: device memory. On an iteration that advances, per
// pixel, `cg_dot` reads K3's L q, q, the known mask and p and writes y in
// place of L q (5 planes), `cg_advance` reads y, p, x, r and the
// preconditioner and writes x and r (7), `cg_direction` reads the
// preconditioner, r and p and writes p and q (5): 17 float32 planes, 48 us
// at 3.35 TB/s at 4 x 576 x 1024. A restart reads the right-hand side b in
// place of x and p; an image that has stopped is skipped.
//
// A sum over an image needs every block of it, and blocks run in no
// order, so each kernel ends where a sum is needed: a block writes its
// float64 partial sums, and every block of the next kernel folds its
// image's partials itself, in a fixed order, and rounds once to float32,
// as `_bsum` does. So every block derives the same per-image scalars, and
// a run repeats its bits. The scalar state (rz, pending, it, active) is
// read from one set of buffers and written to another, because the blocks
// of `cg_direction` that read it run beside the block that writes it; the
// caller alternates the two sets between iterations.
//
// Bits: each product and sum rounds on its own (`--fmad=false`), the
// divide and the square root are correctly rounded, and PyTorch's
// constants are rounded from double to float as PyTorch rounds them. The
// float64 sums add float32 terms in another order than PyTorch's reduction,
// which rounds to the same float32 but for a tie at float64 precision
// (`_bsum`'s argument); the result is the plain `_body`'s bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                   // pixels a thread
constexpr int kTile = kThreads * kItems;    // pixels a block

// the plain path's Python constants, as PyTorch hands them to a float32
// operation
constexpr float kBrokeRel = static_cast<float>(1e-10);
constexpr float kRzFloor = static_cast<float>(1e-30);

// What an iteration does with one image, from p.y and p.p.
struct Turn {
  float step;
  bool broke, restart, advance;
};

// The scalar state an iteration leaves, from Turn, r.z and r.r.
struct Next {
  float beta, rz;
  int it;
  bool update, pending, active;
};

__device__ __forceinline__ Turn turn_of(float pap, float pp, float rz,
                                        bool pending) {
  Turn t;
  t.broke = !(pap > kBrokeRel * pp);
  t.step = rz / (t.broke ? 1.0f : pap);
  t.restart = pending;
  t.advance = !pending && !t.broke;
  return t;
}

__device__ __forceinline__ Next next_of(const Turn& t, float rz2, float rr,
                                        float rz, int it, float bnorm,
                                        float rtol, int max_iter) {
  Next n;
  const float floor_rz = isnan(rz) ? rz : fmaxf(rz, kRzFloor);  // clamp_min
  n.beta = t.advance ? rz2 / floor_rz : 0.0f;
  n.update = t.restart || t.advance;
  n.rz = n.update ? rz2 : rz;
  n.pending = t.broke && !t.restart;
  n.it = it + 1;
  const float res = sqrtf(rr) / bnorm;
  n.active = res > rtol && n.it < max_iter && isfinite(res);
  return n;
}

// The sums over a block of each thread's K values, in a fixed order: each
// warp folds down a fixed tree, then the warps' sums are added in turn.
// Every thread gets the result.
template <int K>
__device__ __forceinline__ void block_sums(double (&v)[K]) {
  __shared__ double sh[K][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
  }
  __syncthreads();  // sh may still be read by a previous call
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) sh[c][warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K; ++c) {
    double s = sh[c][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sh[c][w];
    v[c] = s;
  }
}

// An image's sums from its blocks' float64 partials (nblk x 2, in block
// order), rounded once to float32: thread t adds blocks t, t + kThreads,
// ... in turn, then `block_sums`. Every block that folds the same partials
// gets the same bits.
template <int K>
__device__ __forceinline__ void fold(const double* const (&part)[K / 2],
                                     int nblk, float (&out)[K]) {
  double v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) v[c] = 0.0;
  for (int j = threadIdx.x; j < nblk; j += kThreads) {
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] += part[c / 2][2 * j + c % 2];
  }
  block_sums<K>(v);
#pragma unroll
  for (int c = 0; c < K; ++c) out[c] = static_cast<float>(v[c]);
}

__device__ __forceinline__ Turn image_turn(const double* part1, int img,
                                           int nblk, float rz, bool pending) {
  const double* const parts[1] = {part1 + (int64_t)img * nblk * 2};
  float s[2];
  fold<2>(parts, nblk, s);
  return turn_of(s[0], s[1], rz, pending);
}

__device__ __forceinline__ Next image_next(
    const double* part1, const double* part2, int img, int nblk,
    const float* rz, const uint8_t* pending, const int32_t* it,
    const float* bnorm, float rtol, int max_iter) {
  const double* const parts[2] = {part1 + (int64_t)img * nblk * 2,
                                  part2 + (int64_t)img * nblk * 2};
  float s[4];
  fold<4>(parts, nblk, s);
  const Turn t = turn_of(s[0], s[1], rz[img], pending[img] != 0);
  return next_of(t, s[2], s[3], rz[img], it[img], bnorm[img], rtol, max_iter);
}

// the block's pixels of its image: i(k) = first + k * kThreads + thread
__device__ __forceinline__ int64_t pixel(int k) {
  return (int64_t)blockIdx.x * kTile + (int64_t)k * kThreads + threadIdx.x;
}

// y = L q + (lam C) q in place of L q; partials of p.y and p.p.
__global__ void __launch_bounds__(kThreads)
cg_dot_kernel(float* __restrict__ lq, const float* __restrict__ q,
              const float* __restrict__ known, const float* __restrict__ p,
              const uint8_t* __restrict__ active, int64_t hw, int nblk,
              float lam, double* __restrict__ part1) {
  const int img = blockIdx.y;
  if (!active[img]) return;
  const int64_t off = (int64_t)img * hw;
  float vl[kItems], vq[kItems], vk[kItems], vp[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    const bool in = i < hw;
    vl[k] = in ? lq[off + i] : 0.0f;
    vq[k] = in ? q[off + i] : 0.0f;
    vk[k] = in ? known[off + i] : 0.0f;
    vp[k] = in ? p[off + i] : 0.0f;
  }
  double v[2] = {0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    if (i < hw) {
      const float y = vl[k] + (lam * vk[k]) * vq[k];
      lq[off + i] = y;
      v[0] += (double)(vp[k] * y);
      v[1] += (double)(vp[k] * vp[k]);
    }
  }
  block_sums<2>(v);
  if (threadIdx.x == 0) {
    double* out = part1 + ((int64_t)img * nblk + blockIdx.x) * 2;
    out[0] = v[0];
    out[1] = v[1];
  }
}

// x and r of the active images; partials of r.z and r.r, z = m_inv r.
__global__ void __launch_bounds__(kThreads)
cg_advance_kernel(const float* __restrict__ y, const float* __restrict__ b,
                  const float* __restrict__ m_inv, float* __restrict__ x,
                  float* __restrict__ r, const float* __restrict__ p,
                  const double* __restrict__ part1,
                  const float* __restrict__ rz,
                  const uint8_t* __restrict__ pending,
                  const uint8_t* __restrict__ active, int64_t hw, int nblk,
                  double* __restrict__ part2) {
  const int img = blockIdx.y;
  if (!active[img]) return;
  const Turn t = image_turn(part1, img, nblk, rz[img], pending[img] != 0);
  const int64_t off = (int64_t)img * hw;
  float vm[kItems], vr[kItems], vy[kItems], vx[kItems], vp[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    const bool in = i < hw;
    vm[k] = in ? m_inv[off + i] : 0.0f;
    vr[k] = 0.0f;
    vy[k] = 0.0f;
    vx[k] = 0.0f;
    vp[k] = 0.0f;
    if (!in) continue;
    if (t.restart) {
      vy[k] = y[off + i];
      vr[k] = b[off + i];  // b in r's place: r_r = b - y
    } else if (t.advance) {
      vy[k] = y[off + i];
      vr[k] = r[off + i];
      vx[k] = x[off + i];
      vp[k] = p[off + i];
    } else {
      vr[k] = r[off + i];
    }
  }
  double v[2] = {0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    if (i >= hw) continue;
    float r2;
    if (t.restart) {
      r2 = vr[k] - vy[k];
      r[off + i] = r2;
    } else if (t.advance) {
      x[off + i] = vx[k] + t.step * vp[k];
      r2 = vr[k] - t.step * vy[k];
      r[off + i] = r2;
    } else {
      r2 = vr[k];
    }
    const float z = vm[k] * r2;
    v[0] += (double)(r2 * z);
    v[1] += (double)(r2 * r2);
  }
  block_sums<2>(v);
  if (threadIdx.x == 0) {
    double* out = part2 + ((int64_t)img * nblk + blockIdx.x) * 2;
    out[0] = v[0];
    out[1] = v[1];
  }
}

// p of the active images and K3's next operand q (x where the next
// iteration restarts, else p); block (0, 0) writes every image's new
// scalar state and, where `flag` is given, whether any image is active.
__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(const float* __restrict__ m_inv,
                    const float* __restrict__ r, const float* __restrict__ x,
                    float* __restrict__ p, float* __restrict__ q,
                    const double* __restrict__ part1,
                    const double* __restrict__ part2,
                    const float* __restrict__ rz_in,
                    const uint8_t* __restrict__ pend_in,
                    const int32_t* __restrict__ it_in,
                    const uint8_t* __restrict__ act_in,
                    float* __restrict__ rz_out, uint8_t* __restrict__ pend_out,
                    int32_t* __restrict__ it_out,
                    uint8_t* __restrict__ act_out,
                    const float* __restrict__ bnorm, float rtol, int max_iter,
                    int batch, int64_t hw, int nblk,
                    uint8_t* __restrict__ flag) {
  const int img = blockIdx.y;
  if (blockIdx.x == 0 && img == 0) {
    bool any = false;
    for (int j = 0; j < batch; ++j) {
      if (act_in[j]) {  // the same branch in every thread of the block
        const Next n = image_next(part1, part2, j, nblk, rz_in, pend_in,
                                  it_in, bnorm, rtol, max_iter);
        any = any || n.active;
        if (threadIdx.x == 0) {
          rz_out[j] = n.rz;
          pend_out[j] = n.pending;
          it_out[j] = n.it;
          act_out[j] = n.active;
        }
      } else if (threadIdx.x == 0) {  // a stopped image keeps its state
        rz_out[j] = rz_in[j];
        pend_out[j] = pend_in[j];
        it_out[j] = it_in[j];
        act_out[j] = 0;
      }
    }
    if (flag != nullptr && threadIdx.x == 0) *flag = any;
  }
  if (!act_in[img]) return;
  const Next n = image_next(part1, part2, img, nblk, rz_in, pend_in, it_in,
                            bnorm, rtol, max_iter);
  if (!n.update && q == nullptr) return;
  const int64_t off = (int64_t)img * hw;
  float vm[kItems], vr[kItems], vp[kItems], vx[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    const bool in = i < hw;
    vm[k] = in && n.update ? m_inv[off + i] : 0.0f;
    vr[k] = in && n.update ? r[off + i] : 0.0f;
    vp[k] = in ? p[off + i] : 0.0f;
    vx[k] = in && n.pending && q != nullptr ? x[off + i] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = pixel(k);
    if (i >= hw) continue;
    float p2 = vp[k];
    if (n.update) {
      const float z = vm[k] * vr[k];
      p2 = z + n.beta * vp[k];
      p[off + i] = p2;
    }
    if (q != nullptr) q[off + i] = n.pending ? vx[k] : p2;
  }
}

bool bad_grid(int batch, int64_t hw, int nblk) {
  return batch > 65535 || nblk < 1 || (int64_t)nblk * kTile < hw ||
         (int64_t)(nblk - 1) * kTile >= hw;
}

}  // namespace

extern "C" int iseg_cg_dot(void* lq, const void* q, const void* known,
                           const void* p, const void* active, int batch,
                           int64_t hw, int nblk, float lam, void* part1,
                           void* stream) {
  if (batch <= 0 || hw <= 0) return (int)cudaGetLastError();
  if (bad_grid(batch, hw, nblk)) return (int)cudaErrorInvalidValue;
  cg_dot_kernel<<<dim3(nblk, batch), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(lq), static_cast<const float*>(q),
      static_cast<const float*>(known), static_cast<const float*>(p),
      static_cast<const uint8_t*>(active), hw, nblk, lam,
      static_cast<double*>(part1));
  return (int)cudaGetLastError();
}

extern "C" int iseg_cg_advance(const void* y, const void* b,
                               const void* m_inv, void* x, void* r,
                               const void* p, const void* part1,
                               const void* rz, const void* pending,
                               const void* active, int batch, int64_t hw,
                               int nblk, void* part2, void* stream) {
  if (batch <= 0 || hw <= 0) return (int)cudaGetLastError();
  if (bad_grid(batch, hw, nblk)) return (int)cudaErrorInvalidValue;
  cg_advance_kernel<<<dim3(nblk, batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(b),
      static_cast<const float*>(m_inv), static_cast<float*>(x),
      static_cast<float*>(r), static_cast<const float*>(p),
      static_cast<const double*>(part1), static_cast<const float*>(rz),
      static_cast<const uint8_t*>(pending),
      static_cast<const uint8_t*>(active), hw, nblk,
      static_cast<double*>(part2));
  return (int)cudaGetLastError();
}

extern "C" int iseg_cg_direction(const void* m_inv, const void* r,
                                 const void* x, void* p, void* q,
                                 const void* part1, const void* part2,
                                 const void* rz_in, const void* pend_in,
                                 const void* it_in, const void* act_in,
                                 void* rz_out, void* pend_out, void* it_out,
                                 void* act_out, const void* bnorm, float rtol,
                                 int max_iter, int batch, int64_t hw,
                                 int nblk, void* flag, void* stream) {
  if (batch <= 0 || hw <= 0) return (int)cudaGetLastError();
  if (bad_grid(batch, hw, nblk)) return (int)cudaErrorInvalidValue;
  cg_direction_kernel<<<dim3(nblk, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_inv), static_cast<const float*>(r),
      static_cast<const float*>(x), static_cast<float*>(p),
      static_cast<float*>(q), static_cast<const double*>(part1),
      static_cast<const double*>(part2), static_cast<const float*>(rz_in),
      static_cast<const uint8_t*>(pend_in),
      static_cast<const int32_t*>(it_in),
      static_cast<const uint8_t*>(act_in), static_cast<float*>(rz_out),
      static_cast<uint8_t*>(pend_out), static_cast<int32_t*>(it_out),
      static_cast<uint8_t*>(act_out), static_cast<const float*>(bnorm), rtol,
      max_iter, batch, hw, nblk, static_cast<uint8_t*>(flag));
  return (int)cudaGetLastError();
}
