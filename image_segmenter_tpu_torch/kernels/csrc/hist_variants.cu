// K8: the 256-bin histogram as a 16 x 16 table of (high nibble, low
// nibble), in step-size variants. (B, N) u8 -> (B, 256) int32.
//
// Replaces the pallas_call in bench/micro_hist_nibble.py (hist_variant,
// kernels _make_kernel(rows) for rows 32, 64, 128, 256 and _kernel_n3d).
// On the TPU the count is a product of two one-hot matrices on the matrix
// unit and the variants ask how many elements to put into one product:
// rows x 128 = 4,096, 8,192, 16,384 or 32,768, or a whole block at once.
//
// Bound on this card: device-memory reads, one byte per element (8.29 MB
// a row of 2160 x 3840: about 2.5 us). What costs time is contention:
// equal values met in one warp serialise on one shared-memory counter.
//
// Design: a count on this card is a shared-memory atomic, not a matrix
// product; the TPU's question carries over as how many elements a block
// folds into private tables before it merges them. Each warp owns a 16 x 16
// int32 table [high nibble][low nibble] in shared memory, so the warps of
// a block never contend with each other. A thread takes 16 elements with
// one 16-byte load and folds runs of equal neighbours before it touches the
// table: a run of one value costs one atomic per thread and load instead
// of 16, which is the case the plain per-warp table (K1) is slow on. After
// every step of kStepVecs loads the block merges: thread t sums bin t over
// the warps' tables into a register and clears them. With kStepVecs = 0 the
// block counts its whole share of the row and merges once. At the end each
// thread adds its bin to the row's global counts with one atomic. Exact at
// any size: a row's unaligned head and tail are counted byte by byte, and
// nothing is padded, so there is no bin-0 correction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per bin in the merge
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int* cell(int* table, unsigned v) {
  return table + 16 * (v >> 4) + (v & 15u);
}

// Count the 16 bytes of v, folding runs of equal neighbours.
__device__ __forceinline__ void count_vec(const uint4& v, int* table) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned prev = w[0] & 0xFFu;
  int run = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const unsigned b = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    if (b == prev) {
      ++run;
    } else {
      atomicAdd(cell(table, prev), run);
      prev = b;
      run = 1;
    }
  }
  atomicAdd(cell(table, prev), run);
}

template <int kStepVecs>
__global__ void __launch_bounds__(kThreads)
hist_variant_kernel(const uint8_t* __restrict__ x, int64_t n,
                    int32_t* __restrict__ out) {
  __shared__ int tables[kWarps * 256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) tables[i] = 0;
  __syncthreads();

  int* table = tables + (threadIdx.x / 32) * 256;
  const uint8_t* row = x + (int64_t)blockIdx.y * n;
  int acc = 0;  // this thread's bin

  // unaligned head, 16-byte body, tail
  int64_t head = (16 - (int64_t)((uintptr_t)row & 15)) & 15;
  if (head > n) head = n;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int64_t nvec = (n - head) / 16;
  if (blockIdx.x == 0) {
    for (int64_t i = threadIdx.x; i < head; i += kThreads)
      atomicAdd(cell(table, row[i]), 1);
    for (int64_t i = head + nvec * 16 + threadIdx.x; i < n; i += kThreads)
      atomicAdd(cell(table, row[i]), 1);
  }

  if constexpr (kStepVecs == 0) {
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nvec;
         i += (int64_t)gridDim.x * kThreads)
      count_vec(body[i], table);
  } else {
    const int64_t steps = (nvec + kStepVecs - 1) / kStepVecs;
    for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
      const int64_t lo = s * kStepVecs;
      const int64_t hi = lo + kStepVecs < nvec ? lo + kStepVecs : nvec;
      for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
        count_vec(body[i], table);
      // merge the step: bin t of every warp's table into thread t
      __syncthreads();
      for (int w = 0; w < kWarps; ++w) {
        acc += tables[w * 256 + threadIdx.x];
        tables[w * 256 + threadIdx.x] = 0;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) acc += tables[w * 256 + threadIdx.x];
  if (acc) atomicAdd(out + (int64_t)blockIdx.y * 256 + threadIdx.x, acc);
}

template <int kStepVecs>
int launch(const uint8_t* x, int64_t n, int batch, int32_t* out,
           cudaStream_t s) {
  // a block per step, or per 32,768 elements when the block takes its
  // whole share at once; at most 1024 blocks a row
  const int64_t per_block = kStepVecs ? (int64_t)kStepVecs * 16 : 32768;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  hist_variant_kernel<kStepVecs><<<grid, kThreads, 0, s>>>(x, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// step: the elements a block folds before it merges (4096, 8192, 16384 or
// 32768), or 0 for its whole share of the row in one pass.
extern "C" int iseg_hist_variant(const void* x, int64_t n, int batch,
                                 int step, void* out_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out_counts, 0,
                                    sizeof(int32_t) * 256 * (size_t)batch, s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch <= 0) return (int)cudaGetLastError();
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out_counts);
  switch (step) {
    case 0: return launch<0>(xi, n, batch, oi, s);
    case 4096: return launch<256>(xi, n, batch, oi, s);
    case 8192: return launch<512>(xi, n, batch, oi, s);
    case 16384: return launch<1024>(xi, n, batch, oi, s);
    case 32768: return launch<2048>(xi, n, batch, oi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
