// K8 with the Hopper feed, for bench/sweep_k8.py only (not in the kernel
// library): the counting core, the widening and the epilogue of
// kernels/csrc/hist_variants.cu (included), but the bytes reach shared
// memory by 1D bulk async copies (cp.async.bulk, completion on an
// mbarrier) issued by thread 0 into a ring of kStages chunks of kThreads x
// 16 bytes; every thread then reads its 16 bytes of the chunk from shared
// memory. Thread 0 refills a stage once all threads have arrived on its
// "empty" barrier. Shared memory: 64 KB of counters and kStages x 4 KB.
//
// Entry iseg_hist_variant_bulk: the parameters of iseg_hist_variant, N3D
// only (step 0).

#include "hist_variants.cu"

namespace {

#ifndef K8_STAGES
#define K8_STAGES 2
#endif
constexpr int kStages = K8_STAGES;
constexpr int kChunkBytes = kThreads * 16;
constexpr int kBulkSmem = kTableBytes + kStages * kChunkBytes;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// thread 0: bytes of chunk c into ring stage s, completion on full[s]
__device__ __forceinline__ void issue(uint4* stage, const uint4* src,
                                      unsigned bytes, uint64_t* full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(full)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage)), "l"(src),
      "r"(bytes), "r"(smem_addr(full)) : "memory");
}

__global__ void __launch_bounds__(kThreads)
hist_bulk_kernel(const uint8_t* __restrict__ x, int64_t n,
                 int32_t* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint4* tables = smem;
  uint4* ring = smem + kTableBytes / 16;
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  for (int i = tid; i < kTableBytes / 16; i += kThreads)
    tables[i] = make_uint4(0u, 0u, 0u, 0u);
  char* bytes = reinterpret_cast<char*>(tables);
  const unsigned col = 4u * ((tid / 32) * kWarpWords + (tid & 31));
  const uint8_t* row = x + (int64_t)blockIdx.y * n;
  int64_t head = (16 - (int64_t)((uintptr_t)row & 15)) & 15;
  if (head > n) head = n;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int64_t nvec = (n - head) / 16;
  const int64_t chunks = (nvec + kThreads - 1) / kThreads;
  // this block's chunks: blockIdx.x + k * gridDim.x for k < mine
  const int64_t mine = chunks > blockIdx.x
      ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto chunk_bytes = [&](int64_t k) {
    const int64_t left = nvec - (blockIdx.x + k * gridDim.x) * kThreads;
    return (unsigned)(16 * (left < kThreads ? left : kThreads));
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int64_t k = 0; k < kStages && k < mine; ++k)
      issue(ring + k * kThreads, body + (blockIdx.x + k * gridDim.x) * kThreads,
            chunk_bytes(k), &full[k]);

  if (blockIdx.x == 0) {
    if (tid < head) count_byte(bytes, col, row[tid]);
    const int64_t t = head + nvec * 16 + tid;
    if (t < n) count_byte(bytes, col, row[t]);
  }

  int acc[kBins] = {};
  int64_t k = 0;
  do {
    for (int r = 0; r < kMaxLoads && k < mine; ++r, ++k) {
      const int s = (int)(k % kStages);
      const unsigned use = (unsigned)(k / kStages) & 1u;
      bar_wait(&full[s], use);
      const bool has = tid * 16u < chunk_bytes(k);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (has) v = ring[s * kThreads + tid];
      bar_arrive(&empty[s]);
      if (tid == 0 && k + kStages < mine) {
        bar_wait(&empty[s], use);
        const int64_t c = blockIdx.x + (k + kStages) * gridDim.x;
        issue(ring + s * kThreads, body + c * kThreads, chunk_bytes(k + kStages),
              &full[s]);
      }
      if (has) count_vec(bytes, col, v);
    }
    __syncthreads();
    widen(tables, acc);
    __syncthreads();
  } while (k < mine);

  int32_t* totals = scratch + (int64_t)blockIdx.y * kRow;
#pragma unroll
  for (int j = 0; j < kBins; ++j)
    if (acc[j]) atomicAdd(totals + kBins * tid + j, acc[j]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(totals + 256, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    float* dst = out + (int64_t)blockIdx.y * 256;
    for (int bin = tid; bin < 256; bin += kThreads)
      dst[bin] = (float)atomicExch(totals + bin, 0);
    if (tid == 0) totals[256] = 0;
  }
}

}  // namespace

extern "C" int iseg_hist_variant_bulk(const void* x, int64_t n, int batch,
                                      int step, int blocks_per_row,
                                      void* scratch, void* out, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (batch > 65535 || blocks_per_row < 1 || n < 0 || step != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hist_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks_per_row, (unsigned)batch);
  hist_bulk_kernel<<<grid, kThreads, kBulkSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, static_cast<int32_t*>(scratch),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
