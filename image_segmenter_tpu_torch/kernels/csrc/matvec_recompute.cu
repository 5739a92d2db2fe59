// K6: L @ p of the matting Laplacian, recomputing the window means.
//
// Replaces image_segmenter_tpu/kernels/pallas_matting.py:_kernel (via
// matvec_planes). In: p_pad (B, Hp, Wp), p zero-padded by 2 (Hp = H + 4,
// Wp = W + 4 rounded up to 128), and the static planes (B, 10, Hp, Wp)
// [valid, img_r, img_g, img_b, i1, i2, i3, l21, l31, l32], padded alike.
// Out: (B, Ho, Wp), Ho = ceil(H / 32) * 32, the matvec at [:, :H, :W].
//
// Per centre k (halo 1): n = 9-shift sum of valid; ninv = 1 / max(n, 1);
// mu_c = (sum valid * img_c) * ninv; pbar = (sum valid * p) * ninv;
// cov_c = sum (img_c - mu_c) * (valid * p); the packed-LDL solve on
// cov * ninv; b = pbar - ((a0 mu0 + a1 mu1) + a2 mu2); a and b times the
// centre's validity. Per output pixel: acc = box9(b), then
// acc += box9(a_c) * img_c for c = 0, 1, 2, and out = n * p - acc. Every
// sum runs over the 9 shifts row-major from 0, and the reciprocal is
// multiplied in, as in the TPU kernel: this is not K3's arithmetic (K3
// divides, sums its boxes separably and reads n and mu from planes), so
// the two agree to float32 rounding only. Entries outside [:H, :W] hold
// what the TPU kernel leaves there: partial sums of the windows next to
// the image, zeros further out, zeros in the last 4 columns. Rows of the
// planes past Hp read as zeros (the TPU kernel's padded tail).
//
// Bound on this card: device memory. The call must read the 10 static
// planes and p_pad and write one plane, 12 planes of Hp x Wp against
// K3's 15 of H x W; about 250 float instructions a pixel (the means are
// rebuilt in every call, and no two of them may fuse), about as many
// issue slots as the bytes take of memory time.
//
// Design: K3's strip walk (matvec.cu), adapted. A block walks down a strip
// of SW output columns over a run of rows, one row of window centres a
// step, fed asynchronously.
// - In padded coordinates output pixel (y, x) lies at (y + 2, x + 2), so
//   the windows of a strip starting at x0 read padded columns
//   [x0, x0 + SW + 4): a 16-byte boundary where Wp is a multiple of 4, so
//   every piece of a row is 16 bytes. Stage s is row s + 1 of valid, p and
//   the image and row s of the six factor planes, all 11 over those
//   columns, copied with cp.async into a ring of RP slots kPrefetch stages
//   ahead of the arithmetic. Pieces past column Wp or row Hp are filled
//   with zeros by the copy itself, the plain version's padding. A width
//   that is no multiple of 4, or a misaligned base, takes 4-byte pieces.
// - Thread t owns window centre column x0 + 1 + t. It keeps in registers
//   the 3 x 3 window of valid, valid * p (formed once as the row is read)
//   and the image, three rows that rotate with the step's phase (three
//   unrolled phases, so nothing is moved), plus p at its own column and
//   the window counts of the last rows. A step reads one new row from the
//   ring, closes output row c - 2 from centre rows c - 3 .. c - 1, then
//   computes a0, a1, a2, b of centre row c and writes them, as one float4,
//   to a ring of four centre rows in shared memory. One barrier a step.
// - K6's sums are not separable (each runs over the nine shifts in
//   order), so nothing is carried as column sums: the member boxes read the
//   nine float4 of their windows. With the library built without FMA
//   contraction the result is the plain version's, bit for bit.
// - The grid is strips x row runs x images; the wrapper chooses the run
//   length so that the grid is one wave (kernels/matting.py:run_rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Output columns a block walks down. The SW + 2 window centres of a strip
// take one thread each: 124 fills four warps but for two lanes, where 128
// needs a fifth warp for two centres and issues a quarter more.
constexpr int SW = 124;
constexpr int kThreads = ((SW + 2 + 31) / 32) * 32;
constexpr int kPrefetch = 2;   // stages in flight ahead of the one in use
// slots: the stage in use, kPrefetch in flight, and at a run's first step
// the two stages of the rows above it
constexpr int RP = kPrefetch + 3;
// planes a stage: valid p r g b, then i1 i2 i3 l21 l31 l32
constexpr int NPL = 11;
constexpr int NDATA = 5;       // of them at row s + 1 (the rest at row s)
constexpr int LD = SW + 4;     // a staged row: columns x0 .. x0 + SW + 3
constexpr int SLOT = NPL * LD;
constexpr int kStatic = 10;
// the stage ring, then [4][LD] float4 (a0, a1, a2, b) of four centre rows
constexpr int kFloats = RP * SLOT + 4 * 4 * LD;
static_assert(LD % 4 == 0, "16-byte pieces must start 16-byte aligned");
static_assert(kFloats * sizeof(float) <= 48 * 1024,
              "the rings must fit in shared memory that needs no opt-in");

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes_in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes_in) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes_in) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// What one thread copies in every stage: up to kTasks pieces, the same
// planes and columns each time, one row further down. Worked out once.
struct Piece {
  const float* src;   // the piece's place in row 0 of its plane
  int dst;            // its place in a slot, in floats
  int down;           // 1: valid, p, image (row s + 1); 0: factor (row s);
                      // -1: no piece
  bool col_in;        // its columns lie in the planes
};

template <bool ALIGNED>
struct Loader {
  static constexpr int PIECE = ALIGNED ? 4 : 1;   // floats a piece
  static constexpr int kPieces = LD / PIECE;      // pieces a row
  static constexpr int kTasks = (NPL * kPieces + kThreads - 1) / kThreads;

  Piece task[kTasks];
  int Hp, Wp;

  __device__ __forceinline__ Loader(const float* pb, const float* st,
                                    int64_t plane, int x0, int Hp_, int Wp_)
      : Hp(Hp_), Wp(Wp_) {
#pragma unroll
    for (int m = 0; m < kTasks; ++m) {
      const int i = threadIdx.x + m * kThreads;
      Piece t;
      t.src = pb;
      t.dst = 0;
      t.down = -1;
      t.col_in = false;
      if (i < NPL * kPieces) {
        const int q = i / kPieces, e = i % kPieces;
        const int col = x0 + e * PIECE;
        // stage plane q: valid, p, r, g, b, then the six factors
        const float* base =
            q == 1 ? pb : st + (int64_t)(q == 0 ? 0 : q - 1) * plane;
        t.col_in = col < Wp;
        t.src = base + (t.col_in ? col : 0);
        t.dst = q * LD + e * PIECE;
        t.down = q < NDATA ? 1 : 0;
      }
      task[m] = t;
    }
  }

  // Start stage s into `slot`. Outside the planes nothing is read and the
  // piece is filled with zeros.
  __device__ __forceinline__ void start(float* smem, int s, int slot) const {
#pragma unroll
    for (int m = 0; m < kTasks; ++m) {
      const Piece& t = task[m];
      if (t.down >= 0) {
        const int row = s + t.down;
        const bool in = t.col_in && row >= 0 && row < Hp;
        cp_async<PIECE * 4>(smem + slot * SLOT + t.dst,
                            t.src + (in ? (int64_t)row * Wp : 0),
                            in ? PIECE * 4 : 0);
      }
    }
  }
};

// A window row in registers: valid, valid * p, r, g, b at columns
// X - 1 .. X + 1, then p at X.
constexpr int WV = 0, WVP = 3, WR = 6, WG = 9, WB = 12, WP = 15, WN = 16;

template <bool ALIGNED>
struct Walk {
  float* smem;
  float4* ring;             // [4][LD] (a0, a1, a2, b) of centre rows c & 3
  float* ob;
  Loader<ALIGNED> loader;
  int Wp, c0, c_hi, t, x;
  float win[3][WN], nb[3];

  __device__ __forceinline__ Walk(float* smem_, const float* pb,
                                  const float* st, int64_t plane, float* ob_,
                                  int x0, int Hp, int Wp_, int r0, int r1)
      : smem(smem_), ring(reinterpret_cast<float4*>(smem_ + RP * SLOT)),
        ob(ob_), loader(pb, st, plane, x0, Hp, Wp_), Wp(Wp_), c0(r0 + 1),
        c_hi(r1 + 2), t(threadIdx.x), x(x0 - 1 + (int)threadIdx.x) {}

  __device__ __forceinline__ int slot(int s) const { return (s - c0 + 2) % RP; }

  __device__ __forceinline__ void start(int s) {
    loader.start(smem, s, slot(s));
  }

  // row `row` of valid, p and the image from the ring (stage row - 1)
  __device__ __forceinline__ void load_row(float (&w)[WN], int row) const {
    const float* r = smem + slot(row - 1) * SLOT + t;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float v = r[dx], p = r[LD + dx];
      w[WV + dx] = v;
      w[WVP + dx] = v * p;
      w[WR + dx] = r[2 * LD + dx];
      w[WG + dx] = r[3 * LD + dx];
      w[WB + dx] = r[4 * LD + dx];
    }
    w[WP] = r[LD + 1];
  }

  // Step c with PH = (c - c0) % 3: window rows c - 1, c, c + 1 live in
  // banks PH, PH + 1, PH + 2 (mod 3), and row c - 2, whose output closes
  // here, in bank PH + 2 until row c + 1 replaces it; the count of centre
  // row c goes to nb[PH], that of row c - 2 is in nb[PH + 1].
  template <int PH>
  __device__ __forceinline__ void step(int c) {
    constexpr int BM = PH % 3, B0 = (PH + 1) % 3, BP = (PH + 2) % 3;
    cp_wait<kPrefetch - 1>();   // stage c has landed (this thread's part)
    __syncthreads();            // ... and everyone's; step c - 1 is over
    if (c + kPrefetch <= c_hi) start(c + kPrefetch);
    cp_commit();

    // ---- output row c - 2 from centre rows c - 3 .. c - 1 ---------------
    if (c >= c0 + 3 && t >= 1 && t <= SW && x < Wp) {
      float q = 0.f;
      if (x < Wp - 4) {
        float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int dy = -3; dy <= -1; ++dy) {
          const float4* e = ring + ((c + dy) & 3) * LD + t;
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const float4 v = e[dx];
            box.x = box.x + v.x;
            box.y = box.y + v.y;
            box.z = box.z + v.z;
            box.w = box.w + v.w;
          }
        }
        const float* w = win[BP];
        float acc = box.w;
        acc = acc + box.x * w[WR + 1];
        acc = acc + box.y * w[WG + 1];
        acc = acc + box.z * w[WB + 1];
        q = nb[B0] * w[WP] - acc;
      }
      ob[(int64_t)(c - 4) * Wp + x] = q;
    }

    // ---- a0, a1, a2, b of centre row c ----------------------------------
    if (c <= c_hi && t < SW + 2) {
      if (PH == 0 && c == c0) {
        load_row(win[BM], c - 1);
        load_row(win[B0], c);
      }
      load_row(win[BP], c + 1);
      const float* wr[3] = {win[BM], win[B0], win[BP]};
      float n = 0.f, m0 = 0.f, m1 = 0.f, m2 = 0.f, ps = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* w = wr[dy];
          const float v = w[WV + dx];
          n = n + v;
          m0 = m0 + v * w[WR + dx];
          m1 = m1 + v * w[WG + dx];
          m2 = m2 + v * w[WB + dx];
          ps = ps + w[WVP + dx];
        }
      const float ninv = 1.f / fmaxf(n, 1.f);
      const float mu0 = m0 * ninv, mu1 = m1 * ninv, mu2 = m2 * ninv;
      const float pbar = ps * ninv;
      float cov0 = 0.f, cov1 = 0.f, cov2 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* w = wr[dy];
          const float vp = w[WVP + dx];
          cov0 = cov0 + (w[WR + dx] - mu0) * vp;
          cov1 = cov1 + (w[WG + dx] - mu1) * vp;
          cov2 = cov2 + (w[WB + dx] - mu2) * vp;
        }
      const float* f = smem + slot(c) * SLOT + NDATA * LD + t + 1;
      const float i1 = f[0], i2 = f[LD], i3 = f[2 * LD];
      const float l21 = f[3 * LD], l31 = f[4 * LD], l32 = f[5 * LD];
      const float bq = l21 * l32 - l31;
      const float k0 = cov0 * ninv, k1 = cov1 * ninv, k2 = cov2 * ninv;
      const float t1 = k1 - l21 * k0;
      const float t2 = bq * k0 - l32 * k1 + k2;
      const float w0 = i1 * k0, w1 = i2 * t1, w2 = i3 * t2;
      const float a0 = w0 - l21 * w1 + bq * w2;
      const float a1 = w1 - l32 * w2;
      const float a2 = w2;
      const float bsc = pbar - ((a0 * mu0 + a1 * mu1) + a2 * mu2);
      const float vc = win[B0][WV + 1];   // only real windows contribute
      ring[(c & 3) * LD + t] = make_float4(a0 * vc, a1 * vc, a2 * vc, bsc * vc);
      nb[BM] = n;
    }
  }
};

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
matvec_recompute_kernel(const float* __restrict__ p_pad,
                        const float* __restrict__ stat, int Hp, int Wp,
                        int Ho, int run_rows, float* __restrict__ out) {
  __shared__ __align__(16) float smem[kFloats];
  const int x0 = blockIdx.x * SW;
  const int r0 = blockIdx.y * run_rows;
  const int r1 = min(r0 + run_rows, Ho);   // output rows [r0, r1)
  const int64_t plane = (int64_t)Hp * Wp;
  const int64_t b = blockIdx.z;
  Walk<ALIGNED> walk(smem, p_pad + b * plane, stat + b * kStatic * plane,
                     plane, out + b * Ho * (int64_t)Wp, x0, Hp, Wp, r0, r1);

  // centre rows c0 .. c_hi (padded) feed the output rows; the first also
  // needs the rows of valid, p and the image of stages c0 - 2 and c0 - 1
  const int c0 = walk.c0, c_hi = walk.c_hi;
  walk.start(c0 - 2);
  walk.start(c0 - 1);
  cp_commit();
  for (int s = 0; s < kPrefetch; ++s) {
    if (c0 + s <= c_hi) walk.start(c0 + s);
    cp_commit();
  }
  const int last = c_hi + 1;   // the step that closes output row r1 - 1
  for (int c = c0; c <= last; c += 3) {
    walk.template step<0>(c);
    if (c + 1 <= last) walk.template step<1>(c + 1);
    if (c + 2 <= last) walk.template step<2>(c + 2);
  }
}

}  // namespace

// run_rows: output rows a block covers (the grid has ceil(Ho / run_rows)
// runs).
extern "C" int iseg_matvec_recompute(const void* p_pad, const void* stat,
                                     int batch, int Hp, int Wp, int Ho,
                                     int run_rows, void* out, void* stream) {
  if (batch > 65535 || Hp <= 4 || Wp <= 4 || Ho < Hp - 4 || run_rows < 1
      || (Ho + run_rows - 1) / run_rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch > 0 && Ho > 0) {
    const float* pp = static_cast<const float*>(p_pad);
    const float* st = static_cast<const float*>(stat);
    dim3 grid((Wp + SW - 1) / SW, (Ho + run_rows - 1) / run_rows, batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // whole rows as 16-byte pieces need every row to start on such a boundary
    if (Wp % 4 == 0 && ((uintptr_t)pp | (uintptr_t)st) % 16 == 0)
      matvec_recompute_kernel<true><<<grid, kThreads, 0, s>>>(
          pp, st, Hp, Wp, Ho, run_rows, static_cast<float*>(out));
    else
      matvec_recompute_kernel<false><<<grid, kThreads, 0, s>>>(
          pp, st, Hp, Wp, Ho, run_rows, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
