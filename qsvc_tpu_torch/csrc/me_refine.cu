// K1: one +-1 spiral refinement of every block of every frame pair.
//
// Replaces the Pallas TPU kernel qsvc_tpu/ops/pallas_me.py::refine_pallas
// (_refine_kernel).  Plain PyTorch version: qsvc_tpu_torch/mctf/me.py::
// _refine_level (the lax formulation of qsvc_tpu/mctf/me.py::_refine_level).
//
// What it computes: for each block (p, by, bx) and each of the 9 probes d
// in SPIRAL order, SAD(pred block, PREV at mv_prev + d) and SAD(pred block,
// NEXT at mv_next - d); a later probe wins ties (<=).  Output: the winning
// deltas [dy_prev, dx_prev, dy_next, dx_next] as (P, 4, By, Bx) int32.
//
// Reads clamp into the active (ny, nx) region of the unpadded int16 planes
// (edge replication) instead of reading a padded copy.  The window origin
// also reproduces where the lax gather starts its patch (lax.dynamic_slice
// counts a negative start from the end of the padded axis, then clamps the
// patch into it), so the result equals the plain version for every input,
// not only for |mv| <= max_mv.
//
// What bounds it on the card: each block reads its bs x bs predicted block
// and two (bs+2)^2 reference windows once (~25 KB at bs = 64) and does
// 18 SADs over bs^2 pixels, i.e. ~74K integer ops per 25 KB: neither HBM
// bandwidth nor ALU throughput is near its limit at the flagship sizes
// (at most 8 x 17 x 30 blocks per call).  The design keeps all window reads
// in shared memory (every probe re-reads each window pixel, 9x reuse) and
// keeps the 18 partial sums in registers; one warp-shuffle + shared-memory
// reduction per block replaces the Pallas kernel's per-block roll pair and
// masked 128-lane output store.  There is no lane grouping and no limit on
// Bx: one thread block per (pair, block row, block column).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// |a - b| in int16 arithmetic, as the plain version computes it
__device__ __forceinline__ int abs_diff16(int a, int b) {
  const int d = static_cast<int16_t>(a - b);
  return static_cast<int16_t>(d < 0 ? -d : d);
}

// where lax.dynamic_slice starts a win-long slice of a size-long axis
__device__ __forceinline__ int slice_start(int s, int size, int win) {
  return clampi(s < 0 ? s + size : s, 0, size - win);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
me_refine_kernel(const int16_t* __restrict__ pred,
                 const int16_t* __restrict__ prev,
                 const int16_t* __restrict__ next,
                 const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                 int H, int W, int ny, int nx, int By, int Bx, int bs,
                 int max_mv) {
  // spiral order: later probes win ties; (0,0) last
  const int SY[9] = {-1, -1, 1, 1, -1, 1, 0, 0, 0};
  const int SX[9] = {-1, 1, -1, 1, 0, 0, 1, -1, 0};

  extern __shared__ int16_t smem[];
  const int w2 = bs + 2;
  int16_t* s_pred = smem;                 // bs * bs
  int16_t* s_prev = smem + bs * bs;       // w2 * w2
  int16_t* s_next = s_prev + w2 * w2;     // w2 * w2
  __shared__ int s_red[18][kThreads / 32];

  const int bx = blockIdx.x, by = blockIdx.y, p = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const int16_t* pr = pred + p * plane;
  const int16_t* pv = prev + p * plane;
  const int16_t* nx_ = next + p * plane;
  const int nb = By * Bx;
  const int32_t* m = mv + static_cast<size_t>(p) * 4 * nb + by * Bx + bx;
  const int mvy_p = m[0], mvx_p = m[nb], mvy_n = m[2 * nb], mvx_n = m[3 * nb];

  // window origins in active coordinates: the lax path gathers (bs+2)^2
  // patches at base + mv + max_mv from the active region padded by
  // lo = 1 + max_mv before and enough after (size_y x size_x in all)
  const int lo = 1 + max_mv;
  const int size_y = ny + 2 * lo + w2 + max(0, (By - 1) * bs + w2 - ny);
  const int size_x = nx + 2 * lo + w2 + max(0, (Bx - 1) * bs + w2 - nx);
  const int y0 = by * bs, x0 = bx * bs;
  const int oy_p = slice_start(y0 + mvy_p + max_mv, size_y, w2) - lo;
  const int ox_p = slice_start(x0 + mvx_p + max_mv, size_x, w2) - lo;
  const int oy_n = slice_start(y0 + mvy_n + max_mv, size_y, w2) - lo;
  const int ox_n = slice_start(x0 + mvx_n + max_mv, size_x, w2) - lo;

  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x) {
    const int r = i / bs, c = i - r * bs;
    s_pred[i] = pr[static_cast<size_t>(clampi(y0 + r, 0, ny - 1)) * W +
                   clampi(x0 + c, 0, nx - 1)];
  }
  for (int i = threadIdx.x; i < w2 * w2; i += blockDim.x) {
    const int r = i / w2, c = i - r * w2;
    s_prev[i] = pv[static_cast<size_t>(clampi(oy_p + r, 0, ny - 1)) * W +
                   clampi(ox_p + c, 0, nx - 1)];
    s_next[i] = nx_[static_cast<size_t>(clampi(oy_n + r, 0, ny - 1)) * W +
                    clampi(ox_n + c, 0, nx - 1)];
  }
  __syncthreads();

  int sad_p[9], sad_n[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) sad_p[k] = sad_n[k] = 0;
  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x) {
    const int r = i / bs, c = i - r * bs;
    const int v = s_pred[i];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      // PREV probes at +d, NEXT at -d (window pixel (1,1) is offset 0)
      sad_p[k] += abs_diff16(v, s_prev[(1 + SY[k] + r) * w2 + 1 + SX[k] + c]);
      sad_n[k] += abs_diff16(v, s_next[(1 - SY[k] + r) * w2 + 1 - SX[k] + c]);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int a = warp_sum(sad_p[k]);
    const int b = warp_sum(sad_n[k]);
    if (lane == 0) {
      s_red[k][warp] = a;
      s_red[9 + k][warp] = b;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int nwarps = blockDim.x >> 5;
    int best_p = INT_MAX, best_n = INT_MAX;
    int dyp = 0, dxp = 0, dyn = 0, dxn = 0;
    for (int k = 0; k < 9; ++k) {
      int ep = 0, en = 0;
      for (int w = 0; w < nwarps; ++w) {
        ep += s_red[k][w];
        en += s_red[9 + k][w];
      }
      if (ep <= best_p) { best_p = ep; dyp = SY[k]; dxp = SX[k]; }
      if (en <= best_n) { best_n = en; dyn = -SY[k]; dxn = -SX[k]; }
    }
    int32_t* o = out + static_cast<size_t>(p) * 4 * nb + by * Bx + bx;
    o[0] = dyp;
    o[nb] = dxp;
    o[2 * nb] = dyn;
    o[3 * nb] = dxn;
  }
}

}  // namespace

extern "C" int qsvc_me_refine(const void* pred, const void* prev,
                              const void* next, const void* mv, void* out,
                              int P, int H, int W, int ny, int nx, int By,
                              int Bx, int bs, int max_mv, void* stream) {
  const int w2 = bs + 2;
  const size_t smem = sizeof(int16_t) * (bs * bs + 2 * w2 * w2);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(me_refine_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(Bx, By, P);
  me_refine_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pred), static_cast<const int16_t*>(prev),
      static_cast<const int16_t*>(next), static_cast<const int32_t*>(mv),
      static_cast<int32_t*>(out), H, W, ny, nx, By, Bx, bs, max_mv);
  return static_cast<int>(cudaGetLastError());
}
