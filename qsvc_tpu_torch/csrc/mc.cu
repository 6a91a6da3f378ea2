// K2, K3 and K4: block motion compensation, predict and update.
//
// K2 replaces the Pallas TPU kernel qsvc_tpu/ops/pallas_mc.py::
// predict_pallas (_predict_kernel); plain PyTorch version:
// qsvc_tpu_torch/mctf/predict.py::predict_frame.
// K3 replaces qsvc_tpu/ops/pallas_mc.py::update2_pallas (_update2_kernel)
// and K4 replaces qsvc_tpu/ops/pallas_mc.py::update_pallas
// (_update_kernel); plain PyTorch version of both, one direction at a
// time: qsvc_tpu_torch/mctf/update.py::_update_sums.
//
// What they compute.  K2 (predict): out[p,c,y,x] = clip(tdiv(int16(
// prev[y+mvy_p, x+mvx_p] + next[y+mvy_n, x+mvx_n]), 2), 0, 255) with the
// block's vectors, reads replicating the frame edge.  K3 (update, both
// directions) and K4 (one direction, the sharded MCTF's call):
// destination pixel y of block i sums contrib[y - mv_b] over every
// neighbour block b within K = ceil(search_range / bs) blocks whose
// vector maps y into b; sources outside the frame give 0.  K3 and K4 are
// the two instantiations of one kernel (mc_update_kernel<2> and <1>), so
// the sequential and the sharded MCTF add the same integers.  All take
// the unpadded int16 planes and clamp (K2) or bounds-check (K3, K4) their
// reads.  All place each block patch where the lax gathers they are
// checked against place it (lax.dynamic_slice counts a negative start
// from the end of the padded axis, then clamps the patch into it; K2's
// pad is 4*search_range, K3's and K4's is search_range), so they equal
// the plain versions for every input.  That matters for the update on
// the main path: motion estimation returns vectors up to search_range +
// 1, one past the pad, and at a frame edge such a vector moves the lax
// patch.  The Pallas kernels, padded by a whole block, do not reproduce
// that; the lax version is the reference here.
//
// What bounds them on the card: bytes.  At 1080p (1088 x 1920), P=8
// pairs, C=3, one (P, C, H, W) int16 plane stack is 100.3 MB.  K2 reads
// two of them and writes one: 301 MB, 0.090 ms at 3.35 TB/s.  K3 reads
// the contribution stack once and writes int32 sums for both directions:
// 100.3 + 401.1 = 501 MB, 0.150 ms; K4 writes one direction: 301 MB.
// Their arithmetic is a few integer operations per pixel, so they come
// near the byte bound only if the per-pixel path carries no more than
// that: per-pixel division, vector loads or patch origins would make
// them bound by integer instructions instead (times: PERF.md §6).
//
// The design moves everything that belongs to a block out of the pixel
// path, and has no division there.  One CTA per destination block of one
// pair (grid: block, pair); threads form a (TX, TY) grid over the
// block's rows and column groups, so a thread's row and columns come
// from threadIdx alone.
// - K2: the four vectors and two patch origins are computed once per
//   CTA.  A thread makes 8 consecutive int16 outputs of every component
//   and writes them with one 16-byte store.  A reference whose column
//   run lies inside the frame (every block but those at the left and
//   right edges) is read with two aligned 16-byte loads and a funnel
//   shift by the block-uniform misalignment; rows clamp once per row.
//   Only edge blocks clamp each pixel; a bs that is not a multiple of 8,
//   or planes that are not 16-byte aligned, clamp each pixel and store
//   element by element.
// - K3 and K4: one pass of threads computes, for every neighbour block
//   and direction, the source origin and the rectangle of destination
//   pixels it feeds (its intersection with the block and with the
//   in-frame source), and keeps them in shared memory; more than
//   kChunk neighbours (K >= 4) take several passes.  A thread then owns
//   4 consecutive destination pixels of a row and, for each direction
//   and group of up to 3 components, sums in registers over the
//   rectangles: an empty rectangle is skipped by a branch that is
//   uniform across the CTA, a row outside it by one test per row, and
//   only the column test is per pixel.  The contribution rows of all
//   components share the tests.  The sums go out as 16-byte stores (a
//   bs that is not a multiple of 4 stores element by element).  The sum
//   is a gather of integers: exact, order-free, with no atomics and no
//   shared accumulator, so no limit on bs or K.
// The Pallas kernels' 3x3 neighbourhood staging, rolls and 128-lane
// grouping have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// neighbours whose rectangles one pass of the update holds
constexpr int kChunk = 64;
// components one register sum of the update covers (C = 3 on the main
// path: all of them)
constexpr int kCompGroup = 3;

// (TX, TY) threads over a block: TX column groups of `group` pixels, TY
// rows, at most kThreads in all
dim3 block_threads(int bs, int group) {
  const int tx = std::min(32, (bs + group - 1) / group);
  const int ty = std::max(1, std::min(bs, kThreads / tx));
  return dim3(tx, ty);
}

// ------------------------------------------------------------------ K2

// 8 int16 of a 16-byte aligned row from element a >= 0 on, where
// [a & ~7, (a & ~7) + 16) lies inside the row whenever a & 7 != 0: one or
// two aligned 16-byte loads, shifted by a & 7 (uniform across a block).
__device__ __forceinline__ uint4 load8_aligned(const int16_t* row, int a) {
  const int s = a & 7;
  const uint4* at = reinterpret_cast<const uint4*>(row + (a - s));
  const uint4 lo = __ldg(at);
  if (s == 0) return lo;
  const uint4 hi = __ldg(at + 1);
  uint32_t w0, w1, w2, w3, w4;                 // words s/2 .. s/2 + 4
  switch (s >> 1) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  const unsigned sh = (s & 1) * 16;            // odd s: half a word more
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// 8 int16 of a row from element a on, each column clamped into [0, W)
__device__ __forceinline__ uint4 load8_clamped(const int16_t* row, int a,
                                               int W) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = static_cast<uint16_t>(row[clampi(a + 2 * k, 0, W - 1)]);
    const uint32_t hi =
        static_cast<uint16_t>(row[clampi(a + 2 * k + 1, 0, W - 1)]);
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the prediction of the two int16 lanes of a and b
__device__ __forceinline__ uint32_t predict2(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = static_cast<int16_t>(a >> (16 * h));
    const int y = static_cast<int16_t>(b >> (16 * h));
    // the sum is int16 in the plain version; C division truncates to zero
    const int s = static_cast<int16_t>(x + y);
    r |= static_cast<uint32_t>(clampi(s / 2, 0, 255)) << (16 * h);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
mc_predict_kernel(const int16_t* __restrict__ prev,
                  const int16_t* __restrict__ next,
                  const int32_t* __restrict__ mv, int16_t* __restrict__ out,
                  int C, int H, int W, int Bx, int bs, int border, bool vec) {
  const int blk = blockIdx.x;                  // i * Bx + j
  const int p = blockIdx.y;
  const int i = blk / Bx, j = blk - i * Bx;
  const size_t nb = static_cast<size_t>(gridDim.x);   // By * Bx
  const int32_t* m = mv + static_cast<size_t>(p) * 4 * nb + blk;
  const int sz_y = H + 2 * border, sz_x = W + 2 * border;
  const int oyp = slice_start(i * bs + m[0] + border, sz_y, bs) - border;
  const int oxp = slice_start(j * bs + m[nb] + border, sz_x, bs) - border;
  const int oyn = slice_start(i * bs + m[2 * nb] + border, sz_y, bs) - border;
  const int oxn = slice_start(j * bs + m[3 * nb] + border, sz_x, bs) - border;
  // a reference whose column run lies inside the frame takes aligned loads
  const bool fast_p = vec && oxp >= 0 && oxp + bs <= W;
  const bool fast_n = vec && oxn >= 0 && oxn + bs <= W;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t base = static_cast<size_t>(p) * C * hw;
  for (int r = threadIdx.y; r < bs; r += blockDim.y) {
    const size_t row_p = base + static_cast<size_t>(clampi(oyp + r, 0, H - 1)) * W;
    const size_t row_n = base + static_cast<size_t>(clampi(oyn + r, 0, H - 1)) * W;
    const size_t row_o = base + static_cast<size_t>(i * bs + r) * W + j * bs;
    for (int c = threadIdx.x * 8; c < bs; c += blockDim.x * 8) {
      for (int ch = 0; ch < C; ++ch) {
        const size_t plane = ch * hw;
        const uint4 a = fast_p ? load8_aligned(prev + plane + row_p, oxp + c)
                               : load8_clamped(prev + plane + row_p, oxp + c, W);
        const uint4 b = fast_n ? load8_aligned(next + plane + row_n, oxn + c)
                               : load8_clamped(next + plane + row_n, oxn + c, W);
        const uint4 v = make_uint4(predict2(a.x, b.x), predict2(a.y, b.y),
                                   predict2(a.z, b.z), predict2(a.w, b.w));
        int16_t* o = out + plane + row_o + c;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {                                 // bs % 8 != 0
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          const int n = min(8, bs - c);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (k < n) o[k] = static_cast<int16_t>(w[k >> 1] >> (16 * (k & 1)));
        }
      }
    }
  }
}

// ------------------------------------------------------------- K3, K4

// What neighbour block b gives the destination block: the origin (oy, ox)
// of its source patch and the destination rows [r0, r1) x columns
// [c0, c1) it feeds; r0 == r1 == 0 when it feeds none.
struct Rect {
  int oy, ox, r0, r1, c0, c1;
};

// D directions: K3 (D = 2, mv (P, 2, 2, By, Bx), out (P, 2, C, H, W)) and
// K4 (D = 1, vector planes (P, By, Bx), out (P, C, H, W)).  The vectors of
// pair p, direction d are mv_y / mv_x + p * mv_pair + d * mv_dir.
template <int D>
__global__ void __launch_bounds__(kThreads)
mc_update_kernel(const int16_t* __restrict__ contrib,
                 const int32_t* __restrict__ mv_y,
                 const int32_t* __restrict__ mv_x, int mv_pair, int mv_dir,
                 int32_t* __restrict__ out, int C, int H, int W, int By,
                 int Bx, int bs, int K, int S) {
  __shared__ Rect rects[D * kChunk];
  const int blk = blockIdx.x;                  // i * Bx + j
  const int p = blockIdx.y;
  const int i = blk / Bx, j = blk - i * Bx;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int side = 2 * K + 1, nn = side * side;
  const size_t hw = static_cast<size_t>(H) * W;
  const int16_t* src = contrib + static_cast<size_t>(p) * C * hw;
  int32_t* dst = out + static_cast<size_t>(p) * D * C * hw +
                 static_cast<size_t>(i * bs) * W + j * bs;
  const bool vec = (bs & 3) == 0;
  for (int n0 = 0; n0 < nn; n0 += kChunk) {
    const int cnt = min(kChunk, nn - n0);
    __syncthreads();                           // the last pass's rects are read
    for (int e = tid; e < D * cnt; e += nthreads) {
      const int d = e / cnt, n = n0 + e - d * cnt;
      const int dy = n / side - K, dx = n - (n / side) * side - K;
      const int bi = i + dy, bj = j + dx;
      Rect rc = {0, 0, 0, 0, 0, 0};
      if (bi >= 0 && bi < By && bj >= 0 && bj < Bx) {
        const size_t at = static_cast<size_t>(p) * mv_pair +
                          static_cast<size_t>(d) * mv_dir + bi * Bx + bj;
        const int vy = mv_y[at], vx = mv_x[at];
        // y receives contrib[y - mv_b] iff that source lies in block b:
        // rows [vy + dy*bs, vy + dy*bs + bs) of this block, in frame
        const int oy = slice_start(i * bs - vy + S, H + 2 * S, bs) - S;
        const int ox = slice_start(j * bs - vx + S, W + 2 * S, bs) - S;
        const int ly = vy + dy * bs, lx = vx + dx * bs;
        const int r0 = max(max(ly, 0), -oy), r1 = min(min(ly + bs, bs), H - oy);
        const int c0 = max(max(lx, 0), -ox), c1 = min(min(lx + bs, bs), W - ox);
        if (r0 < r1 && c0 < c1) rc = {oy, ox, r0, r1, c0, c1};
      }
      rects[e] = rc;
    }
    __syncthreads();
    const bool first = n0 == 0;
    for (int r = threadIdx.y; r < bs; r += blockDim.y) {
      for (int c = 4 * threadIdx.x; c < bs; c += 4 * blockDim.x) {
        const int ncol = min(4, bs - c);
        for (int d = 0; d < D; ++d) {
          const Rect* rd = rects + d * cnt;
          for (int ch0 = 0; ch0 < C; ch0 += kCompGroup) {
            const int ncomp = min(kCompGroup, C - ch0);
            int32_t* o = dst + (static_cast<size_t>(d) * C + ch0) * hw +
                         static_cast<size_t>(r) * W + c;
            int acc[kCompGroup][4];
#pragma unroll
            for (int q = 0; q < kCompGroup; ++q)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[q][k] = (!first && q < ncomp && k < ncol)
                                ? o[q * hw + k] : 0;
            for (int n = 0; n < cnt; ++n) {
              const Rect rc = rd[n];
              if (rc.r0 == rc.r1) continue;      // empty: uniform across the CTA
              if (r < rc.r0 || r >= rc.r1) continue;
              // (oy + r, ox + cc) is in frame for every cc in [c0, c1)
              const int row = (rc.oy + r) * W + rc.ox;
              const int16_t* s = src + ch0 * hw;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int cc = c + k;
                if (cc < rc.c0 || cc >= rc.c1) continue;
#pragma unroll
                for (int q = 0; q < kCompGroup; ++q)
                  if (q < ncomp) acc[q][k] += s[q * hw + (row + cc)];
              }
            }
#pragma unroll
            for (int q = 0; q < kCompGroup; ++q) {
              if (q >= ncomp) continue;
              if (vec) {
                *reinterpret_cast<int4*>(o + q * hw) =
                    make_int4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
              } else {                           // bs % 4 != 0
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  if (k < ncol) o[q * hw + k] = acc[q][k];
              }
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int qsvc_mc_predict(const void* prev, const void* next,
                               const void* mv, void* out, int P, int C,
                               int H, int W, int By, int Bx, int bs,
                               int border, void* stream) {
  // 16-byte rows: bs a multiple of 8 and 16-byte aligned planes
  const bool vec = bs % 8 == 0 && aligned16(prev) && aligned16(next) &&
                   aligned16(out);
  mc_predict_kernel<<<dim3(By * Bx, P), block_threads(bs, 8), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(prev), static_cast<const int16_t*>(next),
      static_cast<const int32_t*>(mv), static_cast<int16_t*>(out), C, H, W,
      Bx, bs, border, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsvc_mc_update2(const void* contrib, const void* mv, void* out,
                               int P, int C, int H, int W, int By, int Bx,
                               int bs, int K, int S, void* stream) {
  const int nb = By * Bx;
  const int32_t* m = static_cast<const int32_t*>(mv);
  mc_update_kernel<2><<<dim3(nb, P), block_threads(bs, 4), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(contrib), m, m + nb, 4 * nb, 2 * nb,
      static_cast<int32_t*>(out), C, H, W, By, Bx, bs, K, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsvc_mc_update1(const void* contrib, const void* mv_y,
                               const void* mv_x, void* out, int P, int C,
                               int H, int W, int By, int Bx, int bs, int K,
                               int S, void* stream) {
  mc_update_kernel<1><<<dim3(By * Bx, P), block_threads(bs, 4), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(contrib),
      static_cast<const int32_t*>(mv_y), static_cast<const int32_t*>(mv_x),
      By * Bx, 0, static_cast<int32_t*>(out), C, H, W, By, Bx, bs, K, S);
  return static_cast<int>(cudaGetLastError());
}
