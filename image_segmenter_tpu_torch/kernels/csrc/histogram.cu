// K1: exact 256-bin histogram of u8 rows, (B, N) u8 -> (B, 256) float32,
// one launch a call and nothing beside it.
//
// Replaces image_segmenter_tpu/kernels/pallas_histogram.py:_kernel_nibble
// and :_kernel (via hist256). On the TPU the count ran on the MXU as a
// joint histogram of nibbles; that factorisation has no use here.
//
// Bound on this card: device-memory reads, one byte per element
// (4 x 8.29 MB on the main path, about 10 us of HBM time), and the
// shared-memory atomic, one a byte. Measured on an H100: lanes of a warp
// that add to ONE address cost no more than one lane (the planes the main
// path counts, mostly 0 and 255, run at the memory's rate), while lanes
// that add to different words of one bank take turns (uniform random bytes,
// about 3.5 turns an instruction, are bound by that). So nothing is
// aggregated before the atomic: comparing bytes to find equal ones costs
// more instructions, and more divergent ones, than the atomics it saves.
// What a call loses beyond that is around the counting loop, and the design
// is about that:
// - Few blocks. The caller passes the blocks a row (kernels/histogram.py:
//   blocks_per_row), about two resident blocks an SM over all rows; each
//   walks its row with a grid stride, 16 bytes a load, two loads in flight a
//   thread, and counts into one private 256-bin table per warp in shared
//   memory, so warps never contend with each other. A block folds its
//   tables and adds every non-empty bin to the row's int32 totals in a
//   scratch buffer: some tens of atomics to an address a call, not hundreds.
// - One launch. The last block of a row to finish (a ticket taken with an
//   atomic after __threadfence()) turns the row's totals into the float32
//   output, exact below 2^24, and puts totals and ticket back to zero. The
//   scratch is therefore all zero between calls: the wrapper zeroes it once,
//   when it makes it, and keeps one per device and stream (two calls that
//   share a scratch must not overlap). No memset before the kernel, no cast
//   after it.
// Counts are integers: the result is exact whatever the order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 257;   // ints a row of the scratch: 256 totals, 1 ticket

__device__ __forceinline__ void count_word(unsigned int w, int* h) {
  atomicAdd(h + (w & 0xFFu), 1);
  atomicAdd(h + ((w >> 8) & 0xFFu), 1);
  atomicAdd(h + ((w >> 16) & 0xFFu), 1);
  atomicAdd(h + (w >> 24), 1);
}

__device__ __forceinline__ void count_vec(const uint4& v, int* h) {
  count_word(v.x, h);
  count_word(v.y, h);
  count_word(v.z, h);
  count_word(v.w, h);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ x, int64_t n,
               int32_t* __restrict__ scratch, float* __restrict__ out) {
  __shared__ int tables[kWarps * 256];
  __shared__ bool last_block;
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) tables[i] = 0;
  __syncthreads();

  int* h = tables + (threadIdx.x / 32) * 256;
  const uint8_t* row = x + (int64_t)blockIdx.y * n;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  // unaligned head, 16-byte body (two loads in flight), tail
  int64_t head = (16 - (int64_t)((uintptr_t)row & 15)) & 15;
  if (head > n) head = n;
  for (int64_t i = tid; i < head; i += stride) atomicAdd(h + row[i], 1);
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int64_t nvec = (n - head) / 16;
  for (int64_t i = tid; i < nvec; i += 2 * stride) {
    const bool two = i + stride < nvec;
    const uint4 a = __ldg(body + i);
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    if (two) b = __ldg(body + i + stride);
    count_vec(a, h);
    if (two) count_vec(b, h);
  }
  for (int64_t i = head + nvec * 16 + tid; i < n; i += stride)
    atomicAdd(h + row[i], 1);
  __syncthreads();

  // fold the block's tables into the row's totals
  int32_t* totals = scratch + (int64_t)blockIdx.y * kRow;
  for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += tables[w * 256 + bin];
    if (s) atomicAdd(totals + bin, s);
  }

  // the last block of the row writes the output and clears the scratch
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(totals + 256, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    float* dst = out + (int64_t)blockIdx.y * 256;
    for (int bin = threadIdx.x; bin < 256; bin += kThreads)
      dst[bin] = (float)atomicExch(totals + bin, 0);
    if (threadIdx.x == 0) totals[256] = 0;
  }
}

}  // namespace

// scratch: int32 (at least `batch` rows of 257), all zero on entry and
// again when the kernel has run. blocks_per_row: blocks that share a row.
extern "C" int iseg_hist256(const void* x, int64_t n, int batch,
                            int blocks_per_row, void* scratch, void* out,
                            void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (batch > 65535 || blocks_per_row < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks_per_row, (unsigned)batch);
  hist256_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, static_cast<int32_t*>(scratch),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
