// K1: one +-1 spiral refinement of every block of every frame pair.
//
// Replaces the Pallas TPU kernel qsvc_tpu/ops/pallas_me.py:141
// refine_pallas (_refine_kernel).  Plain PyTorch version: qsvc_tpu_torch/
// mctf/me.py::_refine_level (the lax formulation of qsvc_tpu/mctf/me.py::
// _refine_level), to which it is bit-identical for every block size and
// border.
//
// What it computes: each block (p, by, bx) is matched over a window of
// win = bs + 2 * border pixels around it.  For each of the 9 probes d in
// SPIRAL order it sums |pred - PREV| over the win x win window against
// PREV at mv_prev + d, and against NEXT at mv_next - d; |a - b| is taken
// in int16 (it wraps) and summed in int32 (which wraps too, as the plain
// version's int32 sum does past 2^31); a later probe wins ties (<=).
// Output: the refined vectors mv + [d_prev, d_next] as (P, 2, 2, By, Bx)
// int32.  mv is read through its strides, so a slice of a larger field
// needs no copy.
//
// Reads clamp into the active (ny, nx) region of the unpadded int16 planes
// (edge replication) instead of reading a padded copy.  The window origins
// also reproduce where the lax gathers start their patches: the predicted
// window at base - border, the reference windows (win + 2 wide, the margin
// of the +-1 probes) at base + mv - border - 1, placed as lax.dynamic_slice
// places a patch in the active region padded by lo = border + 1 + max_mv
// before (a negative start counts from the end of the padded axis, then
// the patch is clamped into it).  So the result equals the plain version
// for every input, not only for |mv| <= max_mv.
//
// What bounds it on the card: bytes.  A block reads its window of
// predicted pixels and two (win + 2)^2 windows and does 18 SADs of win^2
// terms; the least work per term is one subtraction and one addition of an
// absolute value, exact on the 128 fp32 lanes of an SM.  At the flagship's
// largest whole-pixel call (P=8, 1088 x 1920, bs 64) that is 0.018 ms of
// arithmetic against 100 MB of planes, 0.030 ms at 3.35 TB/s; its
// sub-pixel calls (bs 128 to 512 on frames interpolated x2 to x8) scale
// both by 4 per step.  Most of the flagship's 14 whole-pixel calls per GOP
// launch fewer CTAs than one wave (down to 4), so there the time is one
// CTA's latency, and at every call a CTA's staging is its longest phase.
// The design:
// - Pieces.  A CTA walks its rows of the window in pieces: column tiles of
//   at most kThreads columns (the window split evenly) and row chunks of as
//   many rows as its threads sum in one pass (about kRun each).  Shared
//   memory holds one piece, so it is bounded whatever bs and border are
//   (at most 55,424 bytes).  The flagship's whole-pixel windows (bs 64)
//   are one piece, and a kernel of its own (kOne) runs them with no
//   piece loop, as fast as before pieces existed.
// - Staging as one round of independent 16-byte copies per piece.  One CTA
//   per (pair, block) (or per part of its rows, below) copies the rows of
//   the piece of the predicted window and of both reference windows into
//   shared memory with cp.async: no registers hold the data and no branch
//   sits between the copies, so all copies of the CTA are in flight at
//   once.  A row is copied whole from a 16-byte aligned column b, as int16,
//   wide enough to hold every column the piece reads after clamping (b is
//   placed so at the frame edges too); the column clamp moves to the SAD
//   loop, where a thread's columns are fixed, so it costs nothing per
//   pixel.  Rows clamp once.  The first piece's predicted rows go out
//   before the vectors are read.  Planes that are not 16-byte aligned (or
//   narrower than a staged row) take element-wise loads instead.
// - The CTA takes the min and max of what it staged for a piece.  If
//   max - min < 2^15 no difference can wrap in int16, so |a - b| is exact
//   in fp32: each value read becomes the fp32 number 12582912 + v (the
//   bits 0x4B400000 + v: one integer add, no conversion), and each term is
//   one FADD and one FADD with an |x| operand; a thread sums at most kRun
//   terms below 2^15 per probe and piece, below 2^24, so exact, then adds
//   the piece's sums to its int32 totals.  Otherwise the CTA runs the
//   int16-wrap arithmetic of the plain version on that piece.
// - Register-blocked SADs: a thread owns one pixel column of the piece and
//   a run of about kRun rows (small CTAs, so that more are resident per SM
//   and one CTA's staging overlaps another's SADs), and slides a 3-row
//   window of each reference through registers, so one shared load serves
//   all three dy probes: 7 shared loads per pixel for 18 terms, no division
//   on the pixel path, the 18 partial sums in registers, one warp
//   reduction (redux) per sum.
// - Small grids: a thread-block cluster of S CTAs (S <= 8) splits each
//   window's rows; the CTAs' 18 sums meet in rank 0 through distributed
//   shared memory, which picks the winner.  One launch, no atomics, no
//   second pass.  The wrapper picks S = 8 where the grid is that small
//   (at most 16 blocks on 132 SMs), else 1.
// Plane offsets are size_t: the sub-pixel stacks pass 2^31 bytes.
// The Pallas kernel's per-block roll pair and masked 128-lane output store
// have no counterpart.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// most threads of a CTA, and the widest column tile of a piece: a thread
// owns one column
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// at most 64 registers a thread (4 CTAs of 256 threads fit on an SM)
constexpr int kMinCtas = 4;
// rows of a thread's column strip in a piece: at bs 64, CTAs of 128
// threads, 7 of which (30 KB of shared memory each) an SM holds; on the
// H100 that ran 13 % faster at the flagship's largest call than strips of
// 4 rows (CTAs of 256, 4 per SM) and 9 % faster per GOP than strips of 64
constexpr int kRun = 32;
constexpr int kFloatBias = 0x4B400000; // fp32 bits of 1.5 * 2^23

// int16 per staged row of a `width`-wide array: a multiple of 8 that holds
// the columns from a 16-byte aligned start on
__host__ __device__ __forceinline__ int staged_row(int width) {
  return (width + 7 + 7) & ~7;
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

// How a CTA walks its rows of a window: pieces of `tw` columns (at most
// kThreads, the window split evenly) by `pr` rows, `threads` threads, each
// owning a column of a piece and up to kRun of its rows.
// (ops/cuda_me.py::layout computes the same.)
struct Layout {
  int win;      // the window's side, bs + 2 * border
  int tw;       // columns of a piece
  int pr;       // rows of a piece
  int threads;  // threads of the CTA
};

__host__ __device__ __forceinline__ Layout layout(int bs, int border,
                                                  int split) {
  Layout L;
  L.win = bs + 2 * border;
  const int tiles = (L.win + kThreads - 1) / kThreads;
  L.tw = (L.win + tiles - 1) / tiles;
  const int nr = (L.win + split - 1) / split;    // a CTA's rows, at most
  const int want = L.tw * ((nr + kRun - 1) / kRun);
  L.threads = imin(kThreads, (want + 31) / 32 * 32);
  L.pr = imin(nr, L.threads / L.tw * kRun);
  return L;
}

// shared memory (bytes) of one piece: its rows of the predicted window and
// of both reference windows (2 more rows and columns each)
__host__ __device__ __forceinline__ int smem_bytes(const Layout& L) {
  return static_cast<int>(sizeof(int16_t)) *
         (L.pr * staged_row(L.tw) + 2 * (L.pr + 2) * staged_row(L.tw + 2));
}

// |a - b| in int16 arithmetic, as the plain version computes it
__device__ __forceinline__ int abs_diff16(int a, int b) {
  const int d = static_cast<int16_t>(a - b);
  return static_cast<int16_t>(d < 0 ? -d : d);
}

// one SAD term: exact fp32 where no difference wraps, else int16 wrap
template <bool kFast>
struct Term;
template <>
struct Term<true> {
  using Val = float;
  // the fp32 number 12582912 + v
  static __device__ __forceinline__ float load(const int16_t* at) {
    return __int_as_float(kFloatBias + *at);
  }
  static __device__ __forceinline__ float of(float v, float a) {
    return fabsf(v - a);
  }
  static __device__ __forceinline__ unsigned to_sum(float s) {
    return static_cast<unsigned>(__float2int_rn(s));
  }
};
template <>
struct Term<false> {
  using Val = int;
  static __device__ __forceinline__ int load(const int16_t* at) {
    return *at;
  }
  static __device__ __forceinline__ int of(int v, int a) {
    return abs_diff16(v, a);
  }
  static __device__ __forceinline__ unsigned to_sum(int s) {
    return static_cast<unsigned>(s);
  }
};

// The staged columns a thread reads, in row 0 of the staged arrays: its
// pred column and, for each reference window, the three columns c, c+1,
// c+2 (clamped into the frame); a row r further on is r * stride away.
struct Cols {
  const int16_t* p;
  const int16_t* w[2][3];
};

template <bool kFast>
__device__ __forceinline__ void load3(typename Term<kFast>::Val (&w)[3],
                                      const int16_t* const (&c)[3], int off) {
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = Term<kFast>::load(c[i] + off);
}

// One row of a column strip, step T of the 3-row rotation: window row i
// (of r, r+1, r+2) sits in slot (T + i) % 3; slot (T + 2) % 3 is loaded.
template <int T, bool kFast>
__device__ __forceinline__ void sad_row(
    int rp, int rw, int r, const Cols& col,
    typename Term<kFast>::Val (&wp)[3][3],
    typename Term<kFast>::Val (&wn)[3][3],
    typename Term<kFast>::Val (&sp)[9], typename Term<kFast>::Val (&sn)[9]) {
  // spiral order: later probes win ties; (0,0) last
  const int SY[9] = {-1, -1, 1, 1, -1, 1, 0, 0, 0};
  const int SX[9] = {-1, 1, -1, 1, 0, 0, 1, -1, 0};
  load3<kFast>(wp[(T + 2) % 3], col.w[0], (r + 2) * rw);
  load3<kFast>(wn[(T + 2) % 3], col.w[1], (r + 2) * rw);
  const auto v = Term<kFast>::load(col.p + r * rp);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    // PREV probes at +d, NEXT at -d (window pixel (1,1) is offset 0)
    sp[k] += Term<kFast>::of(v, wp[(T + 1 + SY[k]) % 3][1 + SX[k]]);
    sn[k] += Term<kFast>::of(v, wn[(T + 1 - SY[k]) % 3][1 - SX[k]]);
  }
}

// adds the 18 SADs of one column over rows [r0, r1) of a piece's staged
// arrays to acc (PREV probes 0-8, NEXT probes 9-17), wrapping as int32
template <bool kFast>
__device__ __forceinline__ void strip_sads(int rp, int rw, const Cols& col,
                                           int r0, int r1,
                                           unsigned (&acc)[18]) {
  typename Term<kFast>::Val sp[9], sn[9], wp[3][3], wn[3][3];
#pragma unroll
  for (int k = 0; k < 9; ++k) sp[k] = sn[k] = 0;
  load3<kFast>(wp[0], col.w[0], r0 * rw);
  load3<kFast>(wp[1], col.w[0], (r0 + 1) * rw);
  load3<kFast>(wn[0], col.w[1], r0 * rw);
  load3<kFast>(wn[1], col.w[1], (r0 + 1) * rw);
  for (int r = r0; r < r1; r += 3) {
    sad_row<0, kFast>(rp, rw, r, col, wp, wn, sp, sn);
    if (r + 1 >= r1) break;
    sad_row<1, kFast>(rp, rw, r + 1, col, wp, wn, sp, sn);
    if (r + 2 >= r1) break;
    sad_row<2, kFast>(rp, rw, r + 2, col, wp, wn, sp, sn);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc[k] += Term<kFast>::to_sum(sp[k]);
    acc[9 + k] += Term<kFast>::to_sum(sn[k]);
  }
}

// 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// wait for this thread's cp.async copies
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One array to stage: `rows` rows from plane row oy on (clamped), each
// `rw` int16 from column b on, into shared memory at dst (row stride rw).
struct Stage {
  const int16_t* plane;
  int oy, b, rows, rw;
  int16_t* dst;
};

// Copy an array with cp.async: a thread copies the fixed 16-byte chunk q
// of rows r0, r0 + rpp, ... (one division; a staged row has fewer chunks
// than the CTA has threads).
__device__ __forceinline__ void stage_async(const Stage& st, int ny, int W,
                                            int tid, int nthreads) {
  const int nq = st.rw >> 3, rpp = nthreads / nq;
  const int r0 = tid / nq, q = tid - r0 * nq;
  if (r0 >= rpp) return;
  const int16_t* src = st.plane + st.b + 8 * q;
  for (int r = r0; r < st.rows; r += rpp)
    cp_async16(st.dst + r * st.rw + 8 * q,
               src + static_cast<size_t>(clampi(st.oy + r, 0, ny - 1)) * W);
}

// kOne: the CTA's rows of the window are one piece (the flagship's
// whole-pixel calls), so the piece loops run once and no sums stay live
// across a piece's staging.  The pieces' kernel allows more registers
// (3 CTAs of 256 threads per SM) to keep its loop state out of local
// memory: on the H100 the sub-pixel calls of an a = 3 GOP took 10.33 ms
// so, against 10.81 ms at 4 CTAs per SM, where it spilled.
template <bool kOne>
__global__ void __launch_bounds__(kThreads, kOne ? kMinCtas : kMinCtas - 1)
me_refine_kernel(const int16_t* __restrict__ pred,
                 const int16_t* __restrict__ prev,
                 const int16_t* __restrict__ next,
                 const int32_t* __restrict__ mv, int mv_sp, int mv_sd,
                 int mv_sc, int mv_sy, int mv_sx, int32_t* __restrict__ out,
                 int H, int W, int ny, int nx, int By, int Bx, int bs,
                 int border, int max_mv, int split, bool vec) {
  extern __shared__ uint4 smem16[];
  __shared__ int s_red[18][kWarps];
  __shared__ int s_tot[18];
  __shared__ int s_lo[kWarps];         // the warps' least staged value
  __shared__ int s_hi[kWarps];         // and greatest

  const Layout L = layout(bs, border, split);
  // a cluster of `split` CTAs along x shares one window, each its rows
  const int rank = split > 1 ? static_cast<int>(blockIdx.x) % split : 0;
  const int bx = blockIdx.x / split, by = blockIdx.y, p = blockIdx.z;
  const int rs = rank * L.win / split, re = (rank + 1) * L.win / split;
  const int w2 = L.win + 2;
  const int rp = staged_row(L.tw), rw = staged_row(L.tw + 2);
  int16_t* s_pred = reinterpret_cast<int16_t*>(smem16);  // pr x rp
  int16_t* s_prev = s_pred + L.pr * rp;                  // (pr + 2) x rw
  int16_t* s_next = s_prev + (L.pr + 2) * rw;            // (pr + 2) x rw

  const size_t plane = static_cast<size_t>(H) * W;
  const int16_t* pred_p = pred + p * plane;
  const int16_t* prev_p = prev + p * plane;
  const int16_t* next_p = next + p * plane;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int y0 = by * bs, x0 = bx * bs;
  // the predicted window's origin in active coordinates (the lax slice of
  // the frame padded by `border` never clamps it)
  const int oy_b = y0 - border, ox_b = x0 - border;
  // the first staged column of an array whose columns start at ox: every
  // clamped column it reads, clamp(ox + j, 0, nx - 1) for j < its width,
  // lies in [b, b + its staged row); 16-byte aligned for the copies
  auto first_col = [&](int ox, int row) {
    const int c0 = clampi(ox, 0, nx - 1);
    return vec ? min(c0 & ~7, W - row) : c0;
  };
  // the first piece's predicted rows go out first: they need no vector
  if (vec)
    stage_async({pred_p, oy_b + rs, first_col(ox_b, rp),
                 min(L.pr, re - rs), rp, s_pred},
                ny, W, tid, nthreads);

  const int32_t* m = mv + static_cast<size_t>(p) * mv_sp +
                     static_cast<size_t>(by) * mv_sy +
                     static_cast<size_t>(bx) * mv_sx;
  const int mvy_p = m[0], mvx_p = m[mv_sc];
  const int mvy_n = m[mv_sd], mvx_n = m[mv_sd + mv_sc];

  // reference window origins in active coordinates: the lax path gathers
  // (win+2)^2 patches at base + mv + max_mv from the active region padded
  // by lo = border + 1 + max_mv before and enough after (size_y x size_x
  // in all)
  const int lo = border + 1 + max_mv;
  const int size_y = ny + 2 * lo + w2 + max(0, (By - 1) * bs + w2 - ny);
  const int size_x = nx + 2 * lo + w2 + max(0, (Bx - 1) * bs + w2 - nx);
  const int oy_p = slice_start(y0 + mvy_p + max_mv, size_y, w2) - lo;
  const int ox_p = slice_start(x0 + mvx_p + max_mv, size_x, w2) - lo;
  const int oy_n = slice_start(y0 + mvy_n + max_mv, size_y, w2) - lo;
  const int ox_n = slice_start(x0 + mvx_n + max_mv, size_x, w2) - lo;

  // thread (tx, ty) owns column tx of a piece and a run of its rows
  const int ty_n = nthreads / L.tw;
  const int ty = tid / L.tw, tx = tid - ty * L.tw;

  unsigned acc[18];
#pragma unroll
  for (int k = 0; k < 18; ++k) acc[k] = 0;

  bool first = true;
  for (int c0 = 0; c0 < L.win; c0 += L.tw) {
    const int tw = min(L.tw, L.win - c0);        // this tile's columns
    const int b_pred = first_col(ox_b + c0, rp);
    const int b_prev = first_col(ox_p + c0, rw);
    const int b_next = first_col(ox_n + c0, rw);
    for (int r0 = rs; r0 < re; r0 += L.pr) {
      const int rows = min(L.pr, re - r0);
      // ---- staging: this piece of the block's window and of both windows
      const Stage st[3] = {
          {pred_p, oy_b + r0, b_pred, rows, rp, s_pred},
          {prev_p, oy_p + r0, b_prev, rows + 2, rw, s_prev},
          {next_p, oy_n + r0, b_next, rows + 2, rw, s_next}};
      if (!first) __syncthreads();     // the last piece has been read
      uint32_t lo2 = 0x7fff7fffu, hi2 = 0x80008000u;  // packed int16 min, max
      if (vec) {
        if (!first) stage_async(st[0], ny, W, tid, nthreads);
        stage_async(st[1], ny, W, tid, nthreads);
        stage_async(st[2], ny, W, tid, nthreads);
        cp_async_wait_all();
        // the min and max of this thread's own chunks
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int nq = st[a].rw >> 3, rpp = nthreads / nq;
          const int q0 = tid / nq, q = tid - q0 * nq;
          if (q0 >= rpp) continue;
          for (int r = q0; r < st[a].rows; r += rpp) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                st[a].dst + r * st[a].rw + 8 * q);
            lo2 = __vmins2(__vmins2(lo2, v.x),
                           __vmins2(v.y, __vmins2(v.z, v.w)));
            hi2 = __vmaxs2(__vmaxs2(hi2, v.x),
                           __vmaxs2(v.y, __vmaxs2(v.z, v.w)));
          }
        }
      } else {
        // element by element, columns clamped (planes off the 16-byte grid)
        for (int a = 0; a < 3; ++a) {
          for (int i = tid; i < st[a].rows * st[a].rw; i += nthreads) {
            const int r = i / st[a].rw, k = i - r * st[a].rw;
            const int16_t v =
                st[a].plane[static_cast<size_t>(
                                clampi(st[a].oy + r, 0, ny - 1)) * W +
                            min(st[a].b + k, nx - 1)];
            st[a].dst[i] = v;
            const uint32_t w = static_cast<uint16_t>(v) * 0x10001u;
            lo2 = __vmins2(lo2, w);
            hi2 = __vmaxs2(hi2, w);
          }
        }
      }
      first = false;
      {
        int mn = min(static_cast<int>(static_cast<int16_t>(lo2 & 0xffffu)),
                     static_cast<int>(lo2) >> 16);
        int mx = max(static_cast<int>(static_cast<int16_t>(hi2 & 0xffffu)),
                     static_cast<int>(hi2) >> 16);
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        if (lane == 0) {
          s_lo[warp] = mn;
          s_hi[warp] = mx;
        }
      }
      __syncthreads();
      int vmin = s_lo[0], vmax = s_hi[0];
      for (int w = 1; w < nwarps; ++w) {
        vmin = min(vmin, s_lo[w]);
        vmax = max(vmax, s_hi[w]);
      }
      // uniform across the CTA: no int16 difference of its values can wrap
      const bool fast = vmax - vmin < 32768;

      // ---- SADs of this piece: a run of R rows of column tx
      const int R = (rows + ty_n - 1) / ty_n;
      const int ra = ty * R, rb = min(rows, ra + R);
      if (ty < ty_n && tx < tw && ra < rb) {
        const int j = c0 + tx;                   // the window's column
        Cols col;
        col.p = s_pred + clampi(ox_b + j, 0, nx - 1) - b_pred;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          col.w[0][i] = s_prev + clampi(ox_p + j + i, 0, nx - 1) - b_prev;
          col.w[1][i] = s_next + clampi(ox_n + j + i, 0, nx - 1) - b_next;
        }
        if (fast)
          strip_sads<true>(rp, rw, col, ra, rb, acc);
        else
          strip_sads<false>(rp, rw, col, ra, rb, acc);
      }
      if (kOne) break;
    }
    if (kOne) break;
  }

  // ---- reduction: warps, then the CTA, then the cluster's rank 0; all
  // adds wrap as int32
#pragma unroll
  for (int k = 0; k < 18; ++k) {
    const unsigned s = __reduce_add_sync(0xffffffffu, acc[k]);
    if (lane == 0) s_red[k][warp] = static_cast<int>(s);
  }
  __syncthreads();
  if (tid < 18) {
    unsigned t = 0;
    for (int w = 0; w < nwarps; ++w) t += static_cast<unsigned>(s_red[tid][w]);
    s_tot[tid] = static_cast<int>(t);
  }
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                    // every rank's s_tot is written
    unsigned t = 0;
    if (rank == 0 && tid < 18)
      for (int q = 0; q < split; ++q)
        t += static_cast<unsigned>(cluster.map_shared_rank(s_tot, q)[tid]);
    cluster.sync();                    // rank 0 has read them all
    if (rank != 0) return;
    if (tid < 18) s_tot[tid] = static_cast<int>(t);
  }
  __syncthreads();

  if (tid == 0) {
    const int SY[9] = {-1, -1, 1, 1, -1, 1, 0, 0, 0};
    const int SX[9] = {-1, 1, -1, 1, 0, 0, 1, -1, 0};
    int best_p = INT_MAX, best_n = INT_MAX;
    int dyp = 0, dxp = 0, dyn = 0, dxn = 0;
    for (int k = 0; k < 9; ++k) {
      if (s_tot[k] <= best_p) { best_p = s_tot[k]; dyp = SY[k]; dxp = SX[k]; }
      if (s_tot[9 + k] <= best_n) {
        best_n = s_tot[9 + k]; dyn = -SY[k]; dxn = -SX[k];
      }
    }
    const int nb = By * Bx;
    int32_t* o = out + static_cast<size_t>(p) * 4 * nb + by * Bx + bx;
    o[0] = mvy_p + dyp;
    o[nb] = mvx_p + dxp;
    o[2 * nb] = mvy_n + dyn;
    o[3 * nb] = mvx_n + dxn;
  }
}

}  // namespace

extern "C" int qsvc_me_refine(const void* pred, const void* prev,
                              const void* next, const void* mv, int mv_sp,
                              int mv_sd, int mv_sc, int mv_sy, int mv_sx,
                              void* out, int P, int H, int W, int ny, int nx,
                              int By, int Bx, int bs, int border, int max_mv,
                              int split, void* stream) {
  const Layout L = layout(bs, border, split);
  const int smem = smem_bytes(L);
  // one piece: one column tile, and the rows of the CTA with the most
  const bool one = L.tw == L.win && L.pr * split >= L.win;
  auto kernel = one ? me_refine_kernel<true> : me_refine_kernel<false>;
  static int smem_set[2] = {48 * 1024, 48 * 1024};   // the default limit
  if (smem > smem_set[one]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[one] = smem;
  }
  // 16-byte copies: 16-byte aligned rows at least one staged row wide
  const bool vec = W % 8 == 0 && W >= staged_row(L.tw + 2) &&
                   aligned16(pred) && aligned16(prev) && aligned16(next);
  const int16_t* a = static_cast<const int16_t*>(pred);
  const int16_t* b = static_cast<const int16_t*>(prev);
  const int16_t* c = static_cast<const int16_t*>(next);
  const int32_t* m = static_cast<const int32_t*>(mv);
  int32_t* o = static_cast<int32_t*>(out);
  const dim3 grid(Bx * split, By, P);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 1) {
    kernel<<<grid, L.threads, smem, s>>>(
        a, b, c, m, mv_sp, mv_sd, mv_sc, mv_sy, mv_sx, o, H, W, ny, nx, By,
        Bx, bs, border, max_mv, split, vec);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, a, b, c, m, mv_sp, mv_sd, mv_sc, mv_sy, mv_sx,
      o, H, W, ny, nx, By, Bx, bs, border, max_mv, split, vec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
