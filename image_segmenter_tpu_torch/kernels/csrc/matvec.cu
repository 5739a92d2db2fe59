// K3: L @ p of the matting Laplacian, one call per CG iteration.
//
// Replaces image_segmenter_tpu/kernels/pallas_matvec.py:_kernel_tiled
// (math in _compute_tile, via matvec_planes_tiled). In: K2's
// (B, 12, H, W) planes, the (B, 3, H, W) image, p (B, H, W). Out:
// (B, H, W).
//
// Per window k centred in the image: psum = 3x3 box of p; pbar = psum/n;
// cov_c = sum_j (I_c(j) - mu_c(k)) p(j); v = cov / n; the packed-LDL solve
// a = Dk^-1 v from [i1, i2, i3, l21, l31, l32]; bb = pbar - a . mu. Per
// pixel i: out = n_i p_i - (sum_c box(a_c)_i I_c(i) + box(bb)_i), the
// boxes over the windows covering i. Windows centred outside the image
// contribute nothing (the TPU kernel got this from zero-padded factors and
// its n > 0 mask).
//
// Bound on this card: device memory. Per pixel the function reads 10
// planes + 3 image planes + p (56 B) and writes 4 B, 141.6 MB at
// 4 x 576 x 1024: 42 us at the card's 3.35 TB/s, about 50 us at the rate
// an elementwise PyTorch kernel reaches on it. The arithmetic is about 135
// operations a pixel, unfused, and with the shared-memory reads and the
// four true divisions some 370 instructions, 25-30 us of the card's
// instruction slots: close enough behind that a kernel which waits for
// its loads before it computes pays for both, and one that re-reads a
// halo around a small tile also asks for 1.4-1.7 x the bytes.
//
// Design: a block walks down a strip of SW output columns, one row of
// windows (a centre row) a step, and is fed asynchronously.
// - Stage k is row k + 1 of p and the image (halo 2: SW + 4 columns) and
//   row k of the ten factor planes (halo 1: SW + 2 columns). Stages are
//   copied into shared-memory rings with cp.async, kPrefetch stages ahead
//   of the arithmetic: the body of a row as aligned 16-byte pieces, the
//   halo columns as 4-byte pieces (a width that is no multiple of 4, or a
//   misaligned base, takes 4-byte pieces throughout). A piece outside the
//   image reads nothing and is filled with zeros by the same instruction,
//   which is the halo's rule. What a thread copies is the same every
//   stage but for the row, so it is worked out once (Loader). Each row of
//   each operand is read once per strip; only the top of a run re-reads
//   (4 rows of p and the image, 2 of the factors).
// - A step has one barrier. Thread t owns column x0 - 1 + t and keeps in
//   registers what it needs again further down: the three rows of its
//   3 x 3 window of p and the image (one new row a step), and the
//   three-column sums of a0, a1, a2, bb of the last two centre rows. It
//   first closes output row c - 2 from the sums of centre row c - 1
//   (written to shared memory by the step before) and the two it carries;
//   then it computes a0, a1, a2, bb of centre row c into the other half of
//   a two-row buffer. The registers rotate with the step's phase (three
//   unrolled phases), so nothing is moved. No ragged rounds, no division
//   by a tile width, every thread of SW + 2 busy in the centre arithmetic.
// - The grid is strips x row runs x images. The caller chooses the run
//   length (kernels/matvec.py:run_rows) so that the grid is one wave: an
//   SM holds three of these blocks (160 threads of 110 registers), and a
//   grid a few blocks over three an SM takes a second wave for them.
// Every box sums columns then rows and the covariance is shift-major, as
// in both the Pallas kernel and the plain version; with the library built
// without FMA contraction the result matches the plain version bit for
// bit on the card. Carrying a row's three-column sums instead of
// recomputing them changes no bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW = 128;       // output columns a block walks down
constexpr int kPrefetch = 2;  // stages in flight ahead of the one in use
constexpr int RP = 8;         // ring rows of p and the image (power of two)
constexpr int RF = 4;         // ring rows of the factor planes (power of two)
constexpr int NF = 10;        // factor planes staged: i1 i2 i3 l21 l31 l32 n mu0 mu1 mu2

constexpr int kThreads = ((SW + 2 + 31) / 32) * 32;
// a row in shared memory: column gx at (gx - x0) + 4, so that the body
// [x0, x0 + SW) starts on a 16-byte boundary
constexpr int LD = SW + 8;
// [4][RP][LD] p, img0, img1, img2; [NF][RF][LD] factors; [2][4][LD] a0, a1,
// a2, bb
constexpr int kFloats = (4 * RP + NF * RF + 2 * 4) * LD;
static_assert(kFloats * sizeof(float) <= 48 * 1024,
              "the rings must fit in shared memory that needs no opt-in");

// cp.async of BYTES (16 or 4) bytes; `bytes_in` of them are read from
// `src` and the rest of the piece is filled with zeros (0: nothing read).
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

// K2's plane of staged factor f (planes 6 and 11 are not read)
__device__ __forceinline__ int plane_of(int f) { return f < 6 ? f : f + 1; }

// What one thread copies in every stage: up to kTasks pieces, the same
// planes and columns each time, one row further down. Worked out once, so
// that a stage costs a thread a few instructions a piece.
struct Piece {
  const float* src;   // the piece's place in row 0 of its plane
  int dst;            // its place in ring row 0, in floats from the base
  int down;           // 1: p or image (row k + 1), 0: factor (row k), -1: none
  bool col_in;        // its columns lie in the image
};

template <bool ALIGNED>
struct Loader {
  static constexpr int NT = kThreads;
  static constexpr int CH = SW / 4;       // 16-byte pieces of a row's body
  static constexpr int kBody = ALIGNED ? (4 + NF) * CH
                                       : 4 * (SW + 4) + NF * (SW + 2);
  static constexpr int kTasks = (kBody + NT - 1) / NT;
  static constexpr int F0 = 4 * RP * LD;  // the factor ring, after p and image

  Piece body[kTasks];
  Piece halo;          // ALIGNED only: one 4-byte halo piece for some threads
  int H, W;

  __device__ __forceinline__ static Piece piece_pi(
      int q, int e, int x0, int W, const float* pb, const float* im,
      int64_t plane) {   // column x0 - 2 + e of p (q 0) or image plane q - 1
    const int gx = x0 - 2 + e;
    Piece t;
    t.col_in = gx >= 0 && gx < W;
    t.src = (q == 0 ? pb : im + (int64_t)(q - 1) * plane) + (t.col_in ? gx : 0);
    t.dst = q * RP * LD + 2 + e;
    t.down = 1;
    return t;
  }

  __device__ __forceinline__ static Piece piece_f(
      int f, int e, int x0, int W, const float* pl, int64_t plane) {
    const int gx = x0 - 1 + e;   // column x0 - 1 + e of staged factor f
    Piece t;
    t.col_in = gx >= 0 && gx < W;
    t.src = pl + (int64_t)plane_of(f) * plane + (t.col_in ? gx : 0);
    t.dst = F0 + f * RF * LD + 3 + e;
    t.down = 0;
    return t;
  }

  __device__ __forceinline__ Loader(const float* pb, const float* im,
                                    const float* pl, int64_t plane, int x0,
                                    int H_, int W_) : H(H_), W(W_) {
    const int tid = threadIdx.x;
    Piece none;
    none.src = pb; none.dst = 0; none.down = -1; none.col_in = false;
#pragma unroll
    for (int m = 0; m < kTasks; ++m) {
      const int i = tid + m * NT;
      Piece t = none;
      if (i < kBody) {
        if (ALIGNED) {
          const int q = i / CH, j = i % CH;
          t = q < 4 ? piece_pi(q, 2 + 4 * j, x0, W, pb, im, plane)
                    : piece_f(q - 4, 1 + 4 * j, x0, W, pl, plane);
        } else if (i < 4 * (SW + 4)) {
          t = piece_pi(i / (SW + 4), i % (SW + 4), x0, W, pb, im, plane);
        } else {
          const int r = i - 4 * (SW + 4);
          t = piece_f(r / (SW + 2), r % (SW + 2), x0, W, pl, plane);
        }
      }
      body[m] = t;
    }
    halo = none;
    if (ALIGNED) {
      if (tid < 16) {                       // halo columns of p and the image
        const int e = tid & 3;
        halo = piece_pi(tid >> 2, e < 2 ? e : SW + e, x0, W, pb, im, plane);
      } else if (tid < 16 + 2 * NF) {       // halo columns of the factors
        halo = piece_f((tid - 16) >> 1, (tid & 1) ? SW + 1 : 0, x0, W, pl,
                       plane);
      }
    }
  }

  // One piece of stage k. Outside the image nothing is read and the piece
  // is filled with zeros: the halo's rule for p and the image (factor
  // entries outside the image are never read).
  template <int BYTES>
  __device__ __forceinline__ void copy(float* smem, const Piece& t, int k,
                                       int least) const {
    if (t.down >= least) {
      const int row = k + t.down;
      const bool in = t.col_in && row >= 0 && row < H;
      const int slot = row & (t.down ? RP - 1 : RF - 1);
      cp_async<BYTES>(smem + t.dst + slot * LD,
                      t.src + (in ? (int64_t)row * W : 0), in ? BYTES : 0);
    }
  }

  // Start stage k: row k + 1 of p and the image and, with_factors, row k
  // of the factor planes.
  __device__ __forceinline__ void start(float* smem, int k,
                                        bool with_factors) const {
    const int least = with_factors ? 0 : 1;
#pragma unroll
    for (int m = 0; m < kTasks; ++m)
      copy<ALIGNED ? 16 : 4>(smem, body[m], k, least);
    if (ALIGNED) copy<4>(smem, halo, k, least);
  }
};

// One thread's walk down its column gx = x0 - 1 + t of the strip. All that
// it carries from row to row lives in three banks that rotate with the
// step's phase PH = (c - c0) % 3, so nothing is moved between registers:
// win[] rows c - 1, c, c + 1 of the 3 x 3 window (p, then the image planes,
// columns gx - 1 .. gx + 1), hb[] the three-column sums of a0, a1, a2, bb
// of centre rows c - 3, c - 2 (and c - 1 once read), nb[] the count.
template <bool ALIGNED>
struct Walk {
  float* smem;
  float* s_a;              // [2][4][LD]: a0, a1, a2, bb of two centre rows
  float* ob;
  Loader<ALIGNED> loader;
  int H, W, r0, r1, c0, t, gx, sx;
  bool col_c, col_o;
  float win[3][12], hb[3][4], nb[3];

  __device__ __forceinline__ Walk(float* smem_, const float* pb,
                                  const float* im, const float* pl,
                                  int64_t plane, float* ob_, int x0, int H_,
                                  int W_, int r0_, int r1_)
      : smem(smem_), s_a(smem_ + (4 * RP + NF * RF) * LD), ob(ob_),
        loader(pb, im, pl, plane, x0, H_, W_), H(H_), W(W_), r0(r0_), r1(r1_),
        c0(r0_ - 1), t(threadIdx.x), gx(x0 - 1 + (int)threadIdx.x),
        sx((int)threadIdx.x + 3) {
    col_c = t < SW + 2 && gx >= 0 && gx < W;   // a window centre
    col_o = t >= 1 && t <= SW && gx < W;       // an output column
  }

  // row `row` of p and the image, columns gx - 1 .. gx + 1, from the ring
  __device__ __forceinline__ void load_row(float (&w)[12], int row) const {
    const float* pr = smem + (row & (RP - 1)) * LD + sx;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) w[3 * q + dx] = pr[q * RP * LD + dx - 1];
  }

  template <int PH>
  __device__ __forceinline__ void step(int c) {
    constexpr int B0 = PH % 3, B1 = (PH + 1) % 3, B2 = (PH + 2) % 3;
    cp_wait<kPrefetch - 1>();   // stage c has landed (this thread's part)
    __syncthreads();            // ... and everyone's; step c - 1 is over
    if (c + kPrefetch <= r1) loader.start(smem, c + kPrefetch, true);
    cp_commit();

    // ---- member boxes: centre row c - 1 closes output row c - 2 ---------
    // hb[B0], hb[B1] hold rows c - 3, c - 2; win[B2] and nb[B0] still hold
    // row c - 2 of p and the image and its count
    if (c > c0 && t >= 1 && t <= SW) {
      const float* ar = s_a + ((c - 1) & 1) * 4 * LD + sx;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hb[B2][q] = (ar[q * LD - 1] + ar[q * LD]) + ar[q * LD + 1];
      const int y = c - 2;
      if (y >= r0 && col_o) {
        float box[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          box[q] = (hb[B0][q] + hb[B1][q]) + hb[B2][q];
        const float* w = win[B2];
        ob[(int64_t)y * W + gx] =
            nb[B0] * w[1] - (((box[0] * w[4] + box[1] * w[7]) + box[2] * w[10])
                             + box[3]);
      }
    }

    // ---- per-window a_k, b_k of centre row c ----------------------------
    float nk = 0.f;
    if (c <= r1 && t < SW + 2) {
      if (PH == 0 && c == c0) {
        load_row(win[B0], c - 1);
        load_row(win[B1], c);
      }
      load_row(win[B2], c + 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, bb = 0.f;
      if (c >= 0 && c < H && col_c) {
        const float* fr = smem + 4 * RP * LD + (c & (RF - 1)) * LD + sx;
        const float ki1 = fr[0], ki2 = fr[RF * LD], ki3 = fr[2 * RF * LD];
        const float kl21 = fr[3 * RF * LD], kl31 = fr[4 * RF * LD],
                    kl32 = fr[5 * RF * LD];
        nk = fr[6 * RF * LD];
        const float mu0 = fr[7 * RF * LD], mu1 = fr[8 * RF * LD],
                    mu2 = fr[9 * RF * LD];

        const float* wr[3] = {win[B0], win[B1], win[B2]};
        float rows[3];
        float cov0 = 0.f, cov1 = 0.f, cov2 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* w = wr[dy];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            cov0 += (w[3 + dx] - mu0) * w[dx];
            cov1 += (w[6 + dx] - mu1) * w[dx];
            cov2 += (w[9 + dx] - mu2) * w[dx];
          }
          rows[dy] = (w[0] + w[1]) + w[2];
        }
        const float psum = (rows[0] + rows[1]) + rows[2];
        const float n_div = fmaxf(nk, 1.f);
        const float pbar = psum / n_div;
        const float bq = kl21 * kl32 - kl31;
        const float v0 = cov0 / n_div, v1 = cov1 / n_div, v2 = cov2 / n_div;
        const float t1 = v1 - kl21 * v0;
        const float t2 = bq * v0 - kl32 * v1 + v2;
        const float w0 = ki1 * v0, w1 = ki2 * t1, w2 = ki3 * t2;
        a0 = w0 - kl21 * w1 + bq * w2;
        a1 = w1 - kl32 * w2;
        a2 = w2;
        bb = pbar - ((a0 * mu0 + a1 * mu1) + a2 * mu2);
      }
      float* aw = s_a + (c & 1) * 4 * LD + sx;
      aw[0] = a0;
      aw[LD] = a1;
      aw[2 * LD] = a2;
      aw[3 * LD] = bb;
    }
    nb[B2] = nk;
  }
};

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const float* __restrict__ planes, const float* __restrict__ img,
              const float* __restrict__ p, int H, int W, int run_rows,
              float* __restrict__ out) {
  __shared__ __align__(16) float smem[kFloats];
  const int x0 = blockIdx.x * SW;
  const int r0 = blockIdx.y * run_rows;
  const int r1 = min(r0 + run_rows, H);   // output rows [r0, r1)
  const int64_t plane = (int64_t)H * W;
  const int64_t b = blockIdx.z;
  Walk<ALIGNED> walk(smem, p + b * plane, img + b * 3 * plane,
                         planes + b * 12 * plane, plane, out + b * plane, x0,
                         H, W, r0, r1);

  // centre rows c0 .. r1 feed the output rows; the first needs rows
  // c0 - 1 and c0 of p and the image besides its own stage
  const int c0 = r0 - 1;
  walk.loader.start(smem, c0 - 2, false);
  walk.loader.start(smem, c0 - 1, false);
  cp_commit();
  for (int s = 0; s < kPrefetch; ++s) {
    if (c0 + s <= r1) walk.loader.start(smem, c0 + s, true);
    cp_commit();
  }
  const int last = r1 + 1;   // the step that closes output row r1 - 1
  for (int c = c0; c <= last; c += 3) {
    walk.template step<0>(c);
    if (c + 1 <= last) walk.template step<1>(c + 1);
    if (c + 2 <= last) walk.template step<2>(c + 2);
  }
}

template <bool ALIGNED>
cudaError_t launch(const float* planes, const float* img, const float* p,
                   int batch, int H, int W, int run_rows, float* out,
                   cudaStream_t stream) {
  dim3 grid((W + SW - 1) / SW, (H + run_rows - 1) / run_rows, batch);
  matvec_kernel<ALIGNED><<<grid, kThreads, 0, stream>>>(
      planes, img, p, H, W, run_rows, out);
  return cudaGetLastError();
}

}  // namespace

// run_rows: output rows a block covers (the grid has ceil(H / run_rows)
// runs).
extern "C" int iseg_matvec(const void* planes, const void* img, const void* p,
                           int batch, int H, int W, int run_rows, void* out,
                           void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (batch > 65535 || run_rows < 1 || (H + run_rows - 1) / run_rows > 65535)
    return (int)cudaErrorInvalidValue;
  const float* pl = static_cast<const float*>(planes);
  const float* im = static_cast<const float*>(img);
  const float* pp = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // whole rows as 16-byte pieces need every row to start on such a boundary
  const bool aligned =
      W % 4 == 0 && ((uintptr_t)pl | (uintptr_t)im | (uintptr_t)pp) % 16 == 0;
  return (int)(aligned
      ? launch<true>(pl, im, pp, batch, H, W, run_rows, o, s)
      : launch<false>(pl, im, pp, batch, H, W, run_rows, o, s));
}
