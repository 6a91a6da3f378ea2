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
// K2 (predict): out[p,c,y,x] = clip(tdiv(prev[y+mvy_p, x+mvx_p] +
// next[y+mvy_n, x+mvx_n], 2), 0, 255) with the block's vectors, reads
// replicating the frame edge.  K3 (update, both directions) and K4 (one
// direction, the sharded MCTF's call): destination pixel y of block i
// sums contrib[y - mv_b] over every neighbour block b within K =
// ceil(search_range / bs) blocks whose vector maps y into b; sources
// outside the frame give 0.  K3 and K4 share that body (update_sum), so
// the sequential and the sharded MCTF add the same integers.  All take
// the unpadded int16 planes and clamp (K2) or bounds-check (K3, K4) their
// reads.  All also place each block patch where the lax gathers they are
// checked against place it (lax.dynamic_slice counts a negative start
// from the end of the padded axis, then clamps the patch into it; K2's
// pad is 4*search_range, K3's and K4's is search_range), so they equal
// the plain versions for every input.  That matters for the update on
// the main path: motion estimation returns vectors up to search_range +
// 1, one past the pad, and at a frame edge such a vector moves the lax
// patch.  The Pallas kernels, padded by a whole block, do not reproduce
// that; the lax version is the reference here.
//
// What bounds them on the card: all are pure data movement with a few
// integer ops per pixel — HBM bandwidth.  At 1080p, P=8, C=3, K2 reads
// 2 x 100 MB and writes 50 MB; K3 reads the 50 MB contribution once per
// neighbour (served from L1/L2: neighbouring threads read neighbouring
// pixels of the same shifted block) and writes 400 MB of int32 sums, K4
// half of that.  The design is one thread per output pixel, neighbouring
// threads on neighbouring pixels so every read and write is coalesced,
// and the per-block vectors are re-read from L1.  The update is a
// gather, so the sum is exact and order-independent with no atomics; the
// Pallas kernels' 3x3 neighbourhood staging, rolls and 128-lane grouping
// have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// where lax.dynamic_slice starts a win-long slice of a size-long axis
__device__ __forceinline__ int slice_start(int s, int size, int win) {
  return clampi(s < 0 ? s + size : s, 0, size - win);
}

__global__ void __launch_bounds__(kThreads)
mc_predict_kernel(const int16_t* __restrict__ prev,
                  const int16_t* __restrict__ next,
                  const int32_t* __restrict__ mv, int16_t* __restrict__ out,
                  int C, int H, int W, int By, int Bx, int bs, int border) {
  const int pc = blockIdx.y;              // p * C + c
  const int p = pc / C;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int y = idx / W, x = idx - y * W;
  const int i = y / bs, j = x / bs;
  const int r = y - i * bs, c = x - j * bs;
  const int nb = By * Bx;
  const int32_t* m = mv + static_cast<size_t>(p) * 4 * nb + i * Bx + j;
  const int sz_y = H + 2 * border, sz_x = W + 2 * border;
  const int syp = clampi(
      slice_start(i * bs + m[0] + border, sz_y, bs) - border + r, 0, H - 1);
  const int sxp = clampi(
      slice_start(j * bs + m[nb] + border, sz_x, bs) - border + c, 0, W - 1);
  const int syn = clampi(
      slice_start(i * bs + m[2 * nb] + border, sz_y, bs) - border + r, 0,
      H - 1);
  const int sxn = clampi(
      slice_start(j * bs + m[3 * nb] + border, sz_x, bs) - border + c, 0,
      W - 1);
  const size_t plane = static_cast<size_t>(pc) * H * W;
  // the sum is int16 in the plain version; C division truncates to zero
  const int a = prev[plane + static_cast<size_t>(syp) * W + sxp];
  const int b = next[plane + static_cast<size_t>(syn) * W + sxn];
  const int s = static_cast<int16_t>(a + b);
  out[plane + idx] = static_cast<int16_t>(clampi(s / 2, 0, 255));
}

// The update of destination pixel (y, x) from one direction's vectors
// (my, mx: that direction's (By, Bx) planes) and one contribution plane.
__device__ __forceinline__ int update_sum(const int16_t* __restrict__ src,
                                          const int32_t* __restrict__ my,
                                          const int32_t* __restrict__ mx,
                                          int y, int x, int H, int W, int By,
                                          int Bx, int bs, int K, int S) {
  const int i = y / bs, j = x / bs;
  const int r = y - i * bs, c = x - j * bs;
  int acc = 0;
  for (int dy = -K; dy <= K; ++dy) {
    const int bi = i + dy;
    if (bi < 0 || bi >= By) continue;
    for (int dx = -K; dx <= K; ++dx) {
      const int bj = j + dx;
      if (bj < 0 || bj >= Bx) continue;
      const int vy = my[bi * Bx + bj], vx = mx[bi * Bx + bj];
      // y receives contrib[y - mv_b] iff that source lies in block b
      const int ly = vy + dy * bs, lx = vx + dx * bs;
      if (r < ly || r >= ly + bs || c < lx || c >= lx + bs) continue;
      const int sy = slice_start(i * bs - vy + S, H + 2 * S, bs) - S + r;
      const int sx = slice_start(j * bs - vx + S, W + 2 * S, bs) - S + c;
      if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;
      acc += src[static_cast<size_t>(sy) * W + sx];
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
mc_update2_kernel(const int16_t* __restrict__ contrib,
                  const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                  int C, int H, int W, int By, int Bx, int bs, int K, int S) {
  const int z = blockIdx.y;               // (p * 2 + d) * C + c
  const int c_ = z % C;
  const int pd = z / C;                   // p * 2 + d
  const int p = pd >> 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int y = idx / W, x = idx - y * W;
  const int nb = By * Bx;
  const int32_t* my = mv + static_cast<size_t>(pd) * 2 * nb;
  const int16_t* src = contrib + (static_cast<size_t>(p) * C + c_) * H * W;
  out[static_cast<size_t>(z) * H * W + idx] =
      update_sum(src, my, my + nb, y, x, H, W, By, Bx, bs, K, S);
}

__global__ void __launch_bounds__(kThreads)
mc_update1_kernel(const int16_t* __restrict__ contrib,
                  const int32_t* __restrict__ mv_y,
                  const int32_t* __restrict__ mv_x, int32_t* __restrict__ out,
                  int C, int H, int W, int By, int Bx, int bs, int K, int S) {
  const int z = blockIdx.y;               // p * C + c
  const int p = z / C;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int y = idx / W, x = idx - y * W;
  const size_t nb = static_cast<size_t>(By) * Bx;
  const size_t plane = static_cast<size_t>(z) * H * W;
  out[plane + idx] = update_sum(contrib + plane, mv_y + p * nb,
                                mv_x + p * nb, y, x, H, W, By, Bx, bs, K, S);
}

}  // namespace

extern "C" int qsvc_mc_predict(const void* prev, const void* next,
                               const void* mv, void* out, int P, int C,
                               int H, int W, int By, int Bx, int bs,
                               int border, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, P * C);
  mc_predict_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(prev), static_cast<const int16_t*>(next),
      static_cast<const int32_t*>(mv), static_cast<int16_t*>(out), C, H, W,
      By, Bx, bs, border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsvc_mc_update2(const void* contrib, const void* mv, void* out,
                               int P, int C, int H, int W, int By, int Bx,
                               int bs, int K, int S, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, P * 2 * C);
  mc_update2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(contrib), static_cast<const int32_t*>(mv),
      static_cast<int32_t*>(out), C, H, W, By, Bx, bs, K, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsvc_mc_update1(const void* contrib, const void* mv_y,
                               const void* mv_x, void* out, int P, int C,
                               int H, int W, int By, int Bx, int bs, int K,
                               int S, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, P * C);
  mc_update1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(contrib), static_cast<const int32_t*>(mv_y),
      static_cast<const int32_t*>(mv_x), static_cast<int32_t*>(out), C, H, W,
      By, Bx, bs, K, S);
  return static_cast<int>(cudaGetLastError());
}
