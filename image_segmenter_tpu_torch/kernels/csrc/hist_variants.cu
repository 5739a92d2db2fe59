// K8: the 256-bin histogram of u8 rows in step-size variants,
// (B, N) u8 -> (B, 256) float32, one launch a call and nothing beside it.
//
// Replaces the pallas_call in bench/micro_hist_nibble.py:93 (hist_variant,
// kernels _make_kernel(rows) for rows 32, 64, 128, 256 and _kernel_n3d).
// On the TPU the count is a product of two one-hot matrices of the high and
// low nibbles on the matrix unit, and the variants ask how many elements to
// put into one product before the partial table leaves the fast memory:
// rows x 128 = 4,096, 8,192, 16,384 or 32,768, or a whole block at once.
//
// Bound on this card: device-memory reads, one byte an element: 4 x
// 8,294,400 bytes on the main shape, 33.18 MB, 0.0099 ms at 3.35 TB/s.
//
// Why byte counters and not the tensor cores. The TPU's product would be
// mma.sync.m16n8k32 on s8 one-hots with s32 sums, exact; but each 32
// elements need 4 A and 4 B registers a lane, each built by a compare of
// packed nibbles (2-3 instructions), plus the nibble extraction and two
// mma: about 22-26 warp instructions for 32 elements. A byte counter costs
// about 8 (extract, address, shift, load, add, store) and no atomic, so at
// 4 instructions a clock an SM the 33.18 M bytes take about 0.009 ms of
// issue slots, the memory bound; the one-hot product about 3x that.
//
// Design:
// - Lane-private byte counters. Each warp owns 64 words x 32 lanes of
//   packed 8-bit counters (8 KB); byte v of lane L lives in byte v & 3 of
//   word (v >> 2) * 32 + L of its warp's table. Only lane L touches that
//   column, so a count is a plain shared load, add and store, and every
//   access of lane L is in bank L: no conflict and no atomic, whatever the
//   bytes. Random bytes, runs of one value and alpha-like planes cost the
//   same.
// - Widening, which is the variant's step. A counter holds 255, so a lane
//   counts at most kMaxLoads = 15 loads of 16 bytes (240) before the block
//   widens: it sums its tables over lanes and warps into one int32 register
//   a bin (thread t holds bin t) and zeroes them. The sums go in two 16-bit
//   halves of each word (bytes 0 and 2, bytes 1 and 3): at most 256
//   columns x 242 = 61,952 < 65,536 (240 from the loads, 2 from the row's
//   unaligned head and tail, counted into block 0's tables first). The
//   periods are loads a thread (kPeriods, equal to PERIODS of
//   kernels/hist_variants.py): a block of 256 threads folds 4,096 elements
//   a load, so N32, N64, N128 and N256 widen after 1, 2, 4 and 8 loads,
//   their TPU steps; N3D only when the counters force it, every 15. A
//   variant whose step would exceed 15 loads a thread widens at 15 too.
// - Feed: 16-byte __ldg, two loads in flight a thread, the block's chunks
//   of kThreads x 16 bytes taken with a grid stride (histogram.cu's walk).
//   A byte costs about 7.5 instructions (add_at): its counter's address is
//   one shift and one LOP3, its increment a funnel shift.
// - One launch, K1's epilogue (histogram.cu): each block adds its non-zero
//   bins to the row's int32 totals in a scratch buffer; the row's last
//   block, found by a ticket taken after __threadfence(), writes the
//   float32 counts (exact below 2^24) and puts totals and ticket back to
//   zero, so the scratch is zero between calls. The wrapper passes the
//   blocks a row: kBlocksPerSm resident blocks an SM over all rows.
// Counts are integers: the result is exact whatever the order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;   // 64 KB of tables a block: 3 fit an SM
constexpr int kMaxLoads = 15;     // 15 x 16 = 240 <= 255 a byte counter
constexpr int kInFlight = 2;      // 16-byte loads in flight a thread
constexpr int kRow = 257;         // ints a row of the scratch: 256 totals, 1 ticket
constexpr int kWarpWords = 64 * 32;
constexpr int kTableBytes = kWarps * kWarpWords * 4;
// threads that share one word of every table in a widening, bins each holds
constexpr int kShare = kThreads / 64;
constexpr int kBins = 4 / kShare;

// elements a block step (0: N3D) -> loads a thread between two widenings
constexpr int kSteps[] = {4096, 8192, 16384, 32768, 0};
constexpr int kPeriods[] = {1, 2, 4, 8, 15};

static_assert(kThreads % 64 == 0 && kBins * kThreads == 256,
              "a widening gives every thread whole bins");
static_assert(kMaxLoads * 16 + 2 <= 255, "a byte counter holds a period");
static_assert(kWarps <= 8, "col's warp bits (13-15) stay clear of the word's");
static_assert(kThreads * (kMaxLoads * 16 + 2) < 65536,
              "a 16-bit half holds a widening's sum");

// The counting step, about 7.5 instructions a byte. `col` is the lane's
// column as a byte offset into the tables: 4 * (warp * 2048 + lane), bits
// 2-6 and 13-15. Byte b's word, (b >> 2) * 32 words on, is the offset
// (b & 0xFC) << 5, bits 7-12: one shift and one LOP3 that masks and ORs it
// onto col. Its increment 1 << 8 * (b & 3) is a funnel shift of 1 by
// bits 3-4 of s, which holds 8 * (b & 3) in its low 5 bits (the funnel
// shift reads no more of it).
__device__ __forceinline__ void add_at(char* tables, unsigned off, unsigned s) {
  *reinterpret_cast<unsigned*>(tables + off) += __funnelshift_l(0u, 1u, s);
}

__device__ __forceinline__ void count_byte(char* tables, unsigned col,
                                           unsigned v) {
  add_at(tables, col | ((v << 5) & 0x1F80u), (v & 3u) << 3);
}

__device__ __forceinline__ void count_word(char* tables, unsigned col,
                                           unsigned w) {
  const unsigned s = (w & 0x03030303u) << 3;  // 8 * (b & 3), a byte each
  add_at(tables, col | ((w << 5) & 0x1F80u), s);
  add_at(tables, col | ((w >> 3) & 0x1F80u), s >> 8);
  add_at(tables, col | ((w >> 11) & 0x1F80u), s >> 16);
  add_at(tables, col | ((w >> 19) & 0x1F80u), s >> 24);
}

__device__ __forceinline__ void count_vec(char* tables, unsigned col,
                                          const uint4& v) {
  count_word(tables, col, v.x);
  count_word(tables, col, v.y);
  count_word(tables, col, v.z);
  count_word(tables, col, v.w);
}

// Sum the block's byte tables into acc (thread t: bins kBins * t ...) and
// zero them. Thread t reads word t / kShare of 64 columns, four lanes at a
// time; the group of four it starts at turns with t, so the eight threads
// of each phase of a 16-byte access meet eight different groups of banks.
__device__ __forceinline__ void widen(uint4* tables, int (&acc)[kBins]) {
  const int t = threadIdx.x;
  const int word = t / kShare, part = t % kShare;
  unsigned lo = 0, hi = 0;  // bytes 0 and 2, bytes 1 and 3, 16 bits each
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int g = part * 16 + ((i + t) & 15);  // group of 4 columns
    uint4* p = tables + (g >> 3) * (kWarpWords / 4) + word * 8 + (g & 7);
    const uint4 v = *p;
    *p = make_uint4(0u, 0u, 0u, 0u);
    lo += (v.x & 0x00FF00FFu) + (v.y & 0x00FF00FFu) + (v.z & 0x00FF00FFu) +
          (v.w & 0x00FF00FFu);
    hi += ((v.x >> 8) & 0x00FF00FFu) + ((v.y >> 8) & 0x00FF00FFu) +
          ((v.z >> 8) & 0x00FF00FFu) + ((v.w >> 8) & 0x00FF00FFu);
  }
#pragma unroll
  for (int s = 1; s < kShare; s *= 2) {
    lo += __shfl_xor_sync(0xFFFFFFFFu, lo, s);
    hi += __shfl_xor_sync(0xFFFFFFFFu, hi, s);
  }
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const int j = part * kBins + k;  // byte j of the word: bin 4 * word + j
    acc[k] += (int)((((j & 1) ? hi : lo) >> (16 * (j >> 1))) & 0xFFFFu);
  }
}

template <int kPeriod>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
hist_variant_kernel(const uint8_t* __restrict__ x, int64_t n,
                    int32_t* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ uint4 tables[];  // kWarps x 64 words x 32 lanes
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
  __syncthreads();

  // unaligned head and tail (< 16 bytes each), a byte a thread, block 0
  if (blockIdx.x == 0) {
    if (tid < head) count_byte(bytes, col, row[tid]);
    const int64_t t = head + nvec * 16 + tid;
    if (t < n) count_byte(bytes, col, row[t]);
  }

  // chunk c of the row (kThreads loads) goes to block c % gridDim.x; a step
  // is kPeriod chunks of the block, kInFlight loads at a time, then the
  // widening
  int acc[kBins] = {};
  const int64_t chunks = (nvec + kThreads - 1) / kThreads;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t c = blockIdx.x;
  do {
    const int64_t first = c * kThreads + tid;
#pragma unroll
    for (int r = 0; r < kPeriod; r += kInFlight) {
      uint4 v[kInFlight];
      bool has[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int64_t i = first + (r + q) * stride;
        has[q] = r + q < kPeriod && i < nvec;
        v[q] = has[q] ? __ldg(body + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q)
        if (has[q]) count_vec(bytes, col, v[q]);
    }
    __syncthreads();
    widen(tables, acc);
    __syncthreads();
    c += (int64_t)kPeriod * gridDim.x;
  } while (c < chunks);

  // fold the block's bins into the row's totals
  int32_t* totals = scratch + (int64_t)blockIdx.y * kRow;
#pragma unroll
  for (int k = 0; k < kBins; ++k)
    if (acc[k]) atomicAdd(totals + kBins * tid + k, acc[k]);

  // the last block of the row writes the output and clears the scratch
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

template <int kPeriod>
int launch(const uint8_t* x, int64_t n, int batch, int blocks_per_row,
           int32_t* scratch, float* out, cudaStream_t s) {
  // above 48 KB of shared memory a kernel must ask for it, once a device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(hist_variant_kernel<kPeriod>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTableBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  dim3 grid((unsigned)blocks_per_row, (unsigned)batch);
  hist_variant_kernel<kPeriod><<<grid, kThreads, kTableBytes, s>>>(
      x, n, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace

// step: the elements a block folds before it widens (4096, 8192, 16384 or
// 32768), or 0 for as many as its counters hold (N3D). scratch: int32 (at
// least `batch` rows of 257), all zero on entry and again when the kernel
// has run. blocks_per_row: blocks that share a row.
extern "C" int iseg_hist_variant(const void* x, int64_t n, int batch, int step,
                                 int blocks_per_row, void* scratch, void* out,
                                 void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (batch > 65535 || blocks_per_row < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  int32_t* si = static_cast<int32_t*>(scratch);
  float* oi = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (step == kSteps[0])
    return launch<kPeriods[0]>(xi, n, batch, blocks_per_row, si, oi, s);
  if (step == kSteps[1])
    return launch<kPeriods[1]>(xi, n, batch, blocks_per_row, si, oi, s);
  if (step == kSteps[2])
    return launch<kPeriods[2]>(xi, n, batch, blocks_per_row, si, oi, s);
  if (step == kSteps[3])
    return launch<kPeriods[3]>(xi, n, batch, blocks_per_row, si, oi, s);
  if (step == kSteps[4])
    return launch<kPeriods[4]>(xi, n, batch, blocks_per_row, si, oi, s);
  return (int)cudaErrorInvalidValue;
}
