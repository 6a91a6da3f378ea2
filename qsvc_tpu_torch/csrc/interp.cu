// K6 and K7: the MCTF's 5/3 interpolation and decimation (int16), each a
// whole region's x2 steps in one launch.
//
// Replace no TPU kernel: the JAX package's upsample2 and downsample2
// (qsvc_tpu/ops/dwt2d.py) are plain jnp.  Plain PyTorch versions, which
// CPU tensors take: qsvc_tpu_torch/ops/dwt2d.py::_interp_axis and
// _low_axis, composed by dwt2d.interpolate and dwt2d.decimate.
//
// What they compute.  K6 (interp_up_kernel): S steps of zero-high 5/3
// synthesis, each columns then rows; along an axis of n samples even =
// x[i], odd = tdiv(x[i] + x[min(i + 1, n - 1)], 2).  K7
// (interp_down_kernel): S steps of the 5/3 analysis' low band, each rows
// then columns; along an axis of 2m samples se = x[2i], so = x[2i + 1],
// h[i] = so[i] - tdiv(se[i] + se[min(i + 1, m - 1)], 2) and
// l[i] = se[i] + tdiv(h[i] + h[max(i - 1, 0)], 4).  Every sum and
// difference wraps in int16 and every division truncates toward zero, as
// the plain version's int16 tensors compute them, so both are
// bit-identical to it for every input.
//
// What bounds them on the card: bytes.  At quarter-pel a 1080p GOP's
// regions need 10.23 GB at least (benchmark/interp_roofline.py), 3.05 ms
// at 3.35 TB/s; the plain version reads and writes the whole stack
// several times a step and axis (~80 ms a GOP).  Here each region's input
// is read once and only its last step's output is written.
//
// The design.  256 threads a CTA, each CTA one tile of the region's
// largest level in one plane.
// K6, 64 x 256 tiles of the output: the input's tile and one sample of
//   halo below and to the right go to shared memory; each step but the
//   last computes the next level's tile and halo there; the last reads 4
//   neighbouring samples of a row and the row below and writes its 2 x 8
//   outputs as two 16-byte stores.
// K7, 64 x 128 tiles of the input (28-43 KB of shared memory, 5-8 CTAs
//   an SM): the tile and the halo its steps read (2 samples a side for
//   the last step, 2 + 2 x that for the one before) go to shared memory
//   with 16-byte loads; each step's rows pass makes 4 samples an item from
//   6 (se, so) pairs read as 32-bit words into a second buffer, its
//   columns pass 4 rows of 2 columns an item back over the first, and the
//   last columns pass writes the output.
// Nothing beyond a level's edge is read: each index a formula reads is
// clamped to the level as the plain version clamps it, so a tile's
// samples past the edge may hold anything.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// the tiles of the region's largest level a CTA covers
constexpr int kUpRows = 64, kUpCols = 256;
constexpr int kDownRows = 64, kDownCols = 128;

// the plain version's int16 arithmetic: sums wrap, divisions truncate
__device__ __forceinline__ int16_t wrap16(int v) {
  return static_cast<int16_t>(v);
}

// tdiv(a + b, 2): the synthesis' odd sample, the analysis' prediction
__device__ __forceinline__ int16_t mid(int16_t a, int16_t b) {
  return static_cast<int16_t>(wrap16(a + b) / 2);
}

// the analysis' high sample h = so - tdiv(se + se_next, 2)
__device__ __forceinline__ int16_t high(int16_t se, int16_t so,
                                        int16_t se_next) {
  return wrap16(so - mid(se, se_next));
}

// the analysis' low sample se + tdiv(h + h_left, 4)
__device__ __forceinline__ int16_t low(int16_t se, int16_t h, int16_t hl) {
  return wrap16(se + wrap16(h + hl) / 4);
}

__device__ __forceinline__ uint32_t pack(int16_t a, int16_t b) {
  return static_cast<uint32_t>(static_cast<uint16_t>(a)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(b)) << 16);
}

__device__ __forceinline__ int16_t lo16(uint32_t x) {
  return static_cast<int16_t>(x & 0xffffu);
}

__device__ __forceinline__ int16_t hi16(uint32_t x) {
  return static_cast<int16_t>(x >> 16);
}

// the analysis' low band at j of an axis of 2m samples, at(g) its sample
// g: every index clamped as the plain version clamps it
template <class At>
__device__ __forceinline__ int16_t low_at(const At& at, int j, int m) {
  const int16_t se = at(2 * j), so = at(2 * j + 1);
  const int16_t h = high(se, so, at(2 * min(j + 1, m - 1)));
  const int16_t hl = j > 0 ? high(at(2 * j - 2), at(2 * j - 1), se) : h;
  return low(se, h, hl);
}

// the low band at j0 ... j0 + 3 from the pairs (se, so) at j0 - 1 ...
// j0 + 4 (so at j0 + 4 unread), where no clamp reaches them
__device__ __forceinline__ void low4(const int16_t* se, const int16_t* so,
                                     int16_t* out) {
  int16_t h[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) h[q] = high(se[q], so[q], se[q + 1]);
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = low(se[q + 1], h[q + 1], h[q]);
}

// K6's tile of level k (0: the input, S: the output), with its halo
template <int S>
struct UpTile {
  __host__ __device__ static constexpr int rows(int k) {
    return (kUpRows >> (S - k)) + 1;
  }
  __host__ __device__ static constexpr int cols(int k) {
    return (kUpCols >> (S - k)) + 1;
  }
  __host__ __device__ static constexpr int offset(int k) {
    int o = 0;
    for (int i = 0; i < k; ++i) o += rows(i) * cols(i);
    return o;
  }
};

// up to two stacks of one frame size: the grid's first planes0 planes
// are the first stack's
struct UpArgs {
  const int16_t* src[2];
  int16_t* dst[2];
  long long src_stride[2];   // samples between two planes of a source
  int planes0;
};

// the synthesis' rows pass over 4 samples of a row and the sample to
// their right: 8 outputs, one 16-byte store where ``vec``, else those
// of the ``room`` left in the row
__device__ __forceinline__ void store_row(int16_t* out, const int16_t* v,
                                          bool vec, int room) {
  int16_t o[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[2 * q] = v[q];
    o[2 * q + 1] = mid(v[q], v[q + 1]);
  }
  if (vec) {
    *reinterpret_cast<uint4*>(out) =
        make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]),
                   pack(o[6], o[7]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < room) out[e] = o[e];
}

// K6: (H, W) planes to (H << S, W << S)
template <int S>
__global__ void __launch_bounds__(kThreads)
    interp_up_kernel(UpArgs args, int H, int W, bool vec) {
  using T = UpTile<S>;
  __shared__ int16_t tile[T::offset(S)];
  // (selected, not indexed: an indexed parameter array goes to local
  // memory)
  const bool second = blockIdx.z >= static_cast<unsigned>(args.planes0);
  const long long plane = blockIdx.z - (second ? args.planes0 : 0);
  const int16_t* src =
      (second ? args.src[1] : args.src[0]) +
      plane * (second ? args.src_stride[1] : args.src_stride[0]);
  const int Wo = W << S;
  int16_t* dst =
      (second ? args.dst[1] : args.dst[0]) + plane * (H << S) * Wo;
  const int oy = blockIdx.y * kUpRows, ox = blockIdx.x * kUpCols;

  // level 0: the input's samples, read clamped to its edge
  {
    constexpr int C = T::cols(0);
    const int y0 = oy >> S, x0 = ox >> S;
    for (int i = threadIdx.x; i < T::rows(0) * C; i += kThreads) {
      const int y = min(y0 + i / C, H - 1), x = min(x0 + i % C, W - 1);
      tile[i] = src[static_cast<long long>(y) * W + x];
    }
  }
  __syncthreads();

  // levels 1 ... S - 1 in shared memory, each from the one before
#pragma unroll
  for (int k = 1; k < S; ++k) {
    const int16_t* z = tile + T::offset(k - 1);
    int16_t* t = tile + T::offset(k);
    const int Cz = T::cols(k - 1), C = T::cols(k);
    const int ny = H << (k - 1), nx = W << (k - 1);       // level k - 1
    const int zy = oy >> (S - k + 1), zx = ox >> (S - k + 1);
    const int ty = oy >> (S - k), tx = ox >> (S - k);
    for (int i = threadIdx.x; i < T::rows(k) * C; i += kThreads) {
      const int gy = min(ty + i / C, 2 * ny - 1);
      const int gx = min(tx + i % C, 2 * nx - 1);
      const int iy = gy >> 1, ix = gx >> 1;
      const int iy1 = (gy & 1) ? min(iy + 1, ny - 1) : iy;
      const int ix1 = (gx & 1) ? min(ix + 1, nx - 1) : ix;
      const int r0 = (iy - zy) * Cz - zx, r1 = (iy1 - zy) * Cz - zx;
      int16_t v0 = z[r0 + ix], v1 = z[r0 + ix1];
      if (gy & 1) {                                      // columns pass
        v0 = mid(v0, z[r1 + ix]);
        v1 = mid(v1, z[r1 + ix1]);
      }
      t[i] = (gx & 1) ? mid(v0, v1) : v0;                // rows pass
    }
    __syncthreads();
  }

  // the last step: 4 samples of a row of level S - 1 and of the row below
  // give 8 outputs in each of 2 rows
  const int16_t* z = tile + T::offset(S - 1);
  constexpr int Cz = T::cols(S - 1);
  constexpr int kGroups = kUpCols / 8;              // of a row of the tile
  const int ny = H << (S - 1), nx = W << (S - 1);
  const int zy = oy >> 1, zx = ox >> 1;
  for (int i = threadIdx.x; i < kUpRows / 2 * kGroups; i += kThreads) {
    const int iy = zy + i / kGroups, jx = zx + 4 * (i % kGroups);
    if (iy >= ny || jx >= nx) continue;
    const int r0 = (iy - zy) * Cz - zx;
    const int r1 = (min(iy + 1, ny - 1) - zy) * Cz - zx;
    int16_t even[5], odd[5];           // the columns pass's two rows
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int x = min(jx + q, nx - 1);
      even[q] = z[r0 + x];
      odd[q] = mid(even[q], z[r1 + x]);
    }
    int16_t* out = dst + static_cast<long long>(2 * iy) * Wo + 2 * jx;
    store_row(out, even, vec, Wo - 2 * jx);
    store_row(out + Wo, odd, vec, Wo - 2 * jx);
  }
}

// K7's tile of level k (0: the output, S: the input): each step reads 2
// samples on either side of the pairs it needs, so level k's tile starts
// lead(k) samples before 2^k times the output tile's origin; the input's
// columns start at a multiple of 8 (lead_in) for 16-byte loads
template <int S>
struct DownTile {
  __host__ __device__ static constexpr int rows(int k) {
    return k == 0 ? (kDownRows >> S) : 2 * rows(k - 1) + 4;
  }
  __host__ __device__ static constexpr int cols(int k) {
    return k == 0 ? (kDownCols >> S) : 2 * cols(k - 1) + 4;
  }
  __host__ __device__ static constexpr int lead(int k) {
    return k == 0 ? 0 : 2 * lead(k - 1) + 2;
  }
  static constexpr int lead_in = (lead(S) + 7) / 8 * 8;
  static constexpr int cols_in = (lead_in - lead(S) + cols(S) + 7) / 8 * 8;
  // a level, then its rows pass
  static constexpr int level_size = rows(S) * cols_in;
  static constexpr int smem_bytes =
      (level_size + rows(S) * cols(S - 1)) * sizeof(int16_t);
};

// K7: (H << S, W << S) planes to (H, W)
template <int S>
__global__ void __launch_bounds__(kThreads)
    interp_down_kernel(const int16_t* src, long long src_stride,
                       int16_t* dst, int H, int W, bool vec) {
  using T = DownTile<S>;
  extern __shared__ uint4 smem[];
  int16_t* a = reinterpret_cast<int16_t*>(smem);     // a level
  int16_t* b = a + T::level_size;                    // its rows pass
  const int16_t* in = src + blockIdx.z * src_stride;
  int16_t* out = dst + static_cast<long long>(blockIdx.z) * H * W;
  const int oy = blockIdx.y * T::rows(0), ox = blockIdx.x * T::cols(0);
  const int Hi = H << S, Wi = W << S;

  // the input's tile, rows clamped to its edge, columns past it left out
  int ay = (oy << S) - T::lead(S), ax = (ox << S) - T::lead_in;
  if (vec) {
    constexpr int kChunks = T::cols_in / 8;
    for (int i = threadIdx.x; i < T::rows(S) * kChunks; i += kThreads) {
      const int y = clampi(ay + i / kChunks, 0, Hi - 1);
      const int x = ax + 8 * (i % kChunks);
      if (x >= 0 && x < Wi)
        reinterpret_cast<uint4*>(a)[i] = *reinterpret_cast<const uint4*>(
            in + static_cast<long long>(y) * Wi + x);
    }
  } else {
    for (int i = threadIdx.x; i < T::level_size; i += kThreads) {
      const int y = clampi(ay + i / T::cols_in, 0, Hi - 1);
      const int x = ax + i % T::cols_in;
      if (x >= 0 && x < Wi) a[i] = in[static_cast<long long>(y) * Wi + x];
    }
  }
  __syncthreads();

  int pitch = T::cols_in;                            // of level k in a
#pragma unroll
  for (int k = S; k >= 1; --k) {
    // rows pass: level k's rows, level k - 1's columns, 4 an item
    const int C = T::cols(k - 1), G = C / 4;
    const int m = W << (k - 1);
    const int bx = (ox << (k - 1)) - T::lead(k - 1);
    for (int i = threadIdx.x; i < T::rows(k) * G; i += kThreads) {
      const int r = i / G, c = 4 * (i % G), j0 = bx + c;
      const int16_t* row = a + r * pitch - ax;       // by level k's column
      int16_t v[4];
      if (j0 >= 1 && j0 + 4 < m) {                   // no clamp reaches it
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(row + 2 * (j0 - 1));
        int16_t se[6], so[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const uint32_t x = w[q];
          se[q] = lo16(x);
          so[q] = hi16(x);
        }
        low4(se, so, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = low_at([&](int g) { return row[g]; },
                        clampi(j0 + q, 0, m - 1), m);
      }
      *reinterpret_cast<uint2*>(b + r * C + c) =
          make_uint2(pack(v[0], v[1]), pack(v[2], v[3]));
    }
    __syncthreads();
    // columns pass: level k - 1, 4 rows of 2 columns an item, back into
    // a, or the output
    const int n = H << (k - 1);
    const int by = (oy << (k - 1)) - T::lead(k - 1);
    const int G2 = C / 2;
    for (int i = threadIdx.x; i < T::rows(k - 1) / 4 * G2; i += kThreads) {
      const int r0 = 4 * (i / G2), c = 2 * (i % G2), j0 = by + r0;
      const int16_t* col = b + c - ay * C;           // by level k's row
      int16_t v[2][4];                               // [column][row]
      if (j0 >= 1 && j0 + 4 < n) {
        int16_t se[2][6], so[2][6];
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const int y = 2 * (j0 - 1 + q);
          const uint32_t e = *reinterpret_cast<const uint32_t*>(col + y * C);
          se[0][q] = lo16(e);
          se[1][q] = hi16(e);
          if (q < 5) {
            const uint32_t o =
                *reinterpret_cast<const uint32_t*>(col + (y + 1) * C);
            so[0][q] = lo16(o);
            so[1][q] = hi16(o);
          }
        }
        low4(se[0], so[0], v[0]);
        low4(se[1], so[1], v[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[e][q] = low_at([&](int g) { return col[g * C + e]; },
                             clampi(j0 + q, 0, n - 1), n);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + q;
        if (k > 1) {
          *reinterpret_cast<uint32_t*>(a + r * C + c) = pack(v[0][q], v[1][q]);
        } else if (oy + r < H) {
          int16_t* o = out + static_cast<long long>(oy + r) * W + ox + c;
          if (ox + c < W) o[0] = v[0][q];
          if (ox + c + 1 < W) o[1] = v[1][q];
        }
      }
    }
    __syncthreads();
    ay = by;
    ax = bx;
    pitch = C;
  }
}

template <int S>
int launch_up(const UpArgs& args, int planes, int H, int W, bool vec,
              cudaStream_t stream) {
  const dim3 grid(((W << S) + kUpCols - 1) / kUpCols,
                  ((H << S) + kUpRows - 1) / kUpRows, planes);
  interp_up_kernel<S><<<grid, kThreads, 0, stream>>>(args, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_down(const int16_t* src, long long src_stride, int planes,
                int16_t* dst, int H, int W, bool vec, cudaStream_t stream) {
  using T = DownTile<S>;
  static bool smem_set = false;                      // above the default 48 KB
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        interp_down_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((W + T::cols(0) - 1) / T::cols(0),
                  (H + T::rows(0) - 1) / T::rows(0), planes);
  interp_down_kernel<S><<<grid, kThreads, T::smem_bytes, stream>>>(
      src, src_stride, dst, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6 over one or two stacks (planes1 = 0: one) of (H, W) planes, rows
// contiguous, src_stride samples apart; dst (H << steps, W << steps)
// planes, contiguous
extern "C" int qsvc_interp_up(const void* src0, long long stride0,
                              int planes0, void* dst0, const void* src1,
                              long long stride1, int planes1, void* dst1,
                              int H, int W, int steps, void* stream) {
  const UpArgs args = {
      {static_cast<const int16_t*>(src0), static_cast<const int16_t*>(src1)},
      {static_cast<int16_t*>(dst0), static_cast<int16_t*>(dst1)},
      {stride0, stride1},
      planes0};
  // 16-byte stores: whole 8-sample groups in each output row, aligned
  const bool vec = (W << steps) % 8 == 0 && aligned16(dst0) &&
                   (planes1 == 0 || aligned16(dst1));
  const int planes = planes0 + planes1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
    case 1: return launch_up<1>(args, planes, H, W, vec, s);
    case 2: return launch_up<2>(args, planes, H, W, vec, s);
    case 3: return launch_up<3>(args, planes, H, W, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7 over (H << steps, W << steps) planes, rows contiguous, src_stride
// samples apart; dst (H, W) planes, contiguous
extern "C" int qsvc_interp_down(const void* src, long long src_stride,
                                int planes, void* dst, int H, int W,
                                int steps, void* stream) {
  // 16-byte loads: whole 8-sample groups in each input row, aligned
  const bool vec = (W << steps) % 8 == 0 && src_stride % 8 == 0 &&
                   aligned16(src);
  const int16_t* x = static_cast<const int16_t*>(src);
  int16_t* y = static_cast<int16_t*>(dst);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
    case 1: return launch_down<1>(x, src_stride, planes, y, H, W, vec, s);
    case 2: return launch_down<2>(x, src_stride, planes, y, H, W, vec, s);
    case 3: return launch_down<3>(x, src_stride, planes, y, H, W, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
