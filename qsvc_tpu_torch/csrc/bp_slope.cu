// K5: the bp coder's R-D simulation, one CTA per code-block.
//
// Replaces no TPU kernel: the JAX package computes it in plain jnp
// (qsvc_tpu/codec/bp_device.py::bp_max_slope, no pallas_call).  Plain
// PyTorch version, which CPU tensors take:
// qsvc_tpu_torch/codec/bp_device.py::bp_max_slope_plain.
//
// What it computes.  For each code-block, the byte ends and SSE that the
// native bp coder (native/ebcot.cpp, bp::encode_block) records after each
// of its 3 passes per bit-plane (significance propagation, magnitude
// refinement, cleanup with stripe-of-4 group tests; every pass ends on a
// byte boundary), and from them smax, the largest prefix slope
// (d0 - sse) / bytes, and d0, the SSE at zero rate.  The significance
// entering plane p is (m >> (p + 1)) != 0: pass membership is frozen at
// plane start, so every plane is a set of independent sums.
//
// What bounds it on the card.  The flagship GOP's two stacks hold 15,657
// blocks of 64 x 64 int16 (128 MB): 0.04 ms to read at 3.35 TB/s.  The
// plain version spends ~127 ms on ~40 full-size tensor operations per
// plane, each through device memory.  Here the tile is read once, and
// the per-plane work is on 64-bit row masks, so a plane costs a few
// dozen word operations per row rather than per coefficient.
//
// The design.  64 threads, one per row of the block (cb <= 64).
// 1. The tile is read once (16-byte loads where its rows allow), masked
//    to its true th x tw, and its magnitudes go to shared memory; the
//    block's max gives msbs (an all-zero block writes 0 and leaves) and
//    the exact int64 sum of squares gives d0.
// 2. Ballots turn the magnitudes into one 64-bit mask per row and plane
//    below msbs (bit x = column x).
// 3. For p = msbs - 1 ... 0 each thread holds the significance masks of
//    its row and the rows above and below, builds the 8-neighbour mask
//    by shifts and ORs (clipped to the block as the coder clips it), and
//    counts pass members with popcounts; 4 neighbouring lanes add the
//    cleanup pass's stripe counts.  The SSE deltas are exact integers in
//    closed form: a coefficient first significant at p (m = 2^p + r) adds
//    -3h^2 - 6hr, a refined one h^2 - 2hr (bit 1) or 2hr - 3h^2 (bit 0),
//    h = 2^(p-1) (p = 0: -1 and -[bit 0]), and the sum of r over a row
//    set is the sum over q < p of 2^q popcount(plane q & set).  Warp
//    reductions leave per plane and warp 10 int32 sums in shared memory.
// 4. One thread turns them into the 3 * msbs passes' (bytes, dSSE), each
//    dSSE an exact int64 rounded to float32 once, and runs the plain
//    version's float32 prefix in its order: ends = cumsum(bytes), sse =
//    d0 + cumsum(dsse), slope = (d0 - sse) / max(ends, 1) where ends > 0,
//    smax = max (planes at or above msbs add exact zeros there).  So the
//    result differs from the plain version only where the plain
//    version's float32 block sums rounded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// rows of a code-block at most, one thread each
constexpr int kMaxCb = 64;
constexpr int kThreads = kMaxCb;
constexpr int kWarps = kThreads / 32;
// |int16| <= 32768 has at most 16 bit-planes
constexpr int kPlanes = 16;
constexpr unsigned kFull = 0xffffffffu;

// the per-plane sums of a row set: pass members and ones, and "rest", the
// sum of r = m mod 2^p over a set of ones
enum Stat {
  kSppMembers, kSppOnes, kSppRest,    // significance propagation
  kMrOnes, kMrOnesRest, kMrZeros, kMrZerosRest,   // refinement
  kCpOnes, kCpRest, kCpBits,          // cleanup
  kStats
};

// dSSE of n coefficients first significant at plane p, r summing to rest:
// m = 2^p + r is reconstructed at 2^p + h, h = 2^(p-1), so
// (r - h)^2 - (2h + r)^2 = -3h^2 - 6hr; at p = 0, m = 1 is exact: -1
__device__ __forceinline__ int64_t fresh_dsse(int p, int64_t n, int64_t rest) {
  if (p == 0) return -n;
  const int64_t h = int64_t{1} << (p - 1);
  return -(3 * h * h * n + 6 * h * rest);
}

// dSSE of refining n1 coefficients whose bit p is 1 and n0 whose bit is 0
// (the coder's closed form: h^2 - 2hr and 2hr - 3h^2; p = 0: -[bit 0])
__device__ __forceinline__ int64_t refine_dsse(int p, int64_t n1,
                                               int64_t rest1, int64_t n0,
                                               int64_t rest0) {
  if (p == 0) return -n0;
  const int64_t h = int64_t{1} << (p - 1);
  return h * h * (n1 - 3 * n0) + 2 * h * (rest0 - rest1);
}

__global__ void __launch_bounds__(kThreads)
bp_slope_kernel(const int16_t* __restrict__ tiles,
                const int32_t* __restrict__ th,
                const int32_t* __restrict__ tw, int lg, bool vec,
                float* __restrict__ smax_out, float* __restrict__ d0_out) {
  __shared__ __align__(16) uint16_t mag[kMaxCb * kMaxCb];
  __shared__ uint64_t plane_rows[kPlanes][kMaxCb];
  __shared__ int32_t stats[kPlanes][kStats][kWarps];
  __shared__ unsigned long long warp_d0[kWarps];
  __shared__ uint32_t warp_max[kWarps];

  const int cb = 1 << lg, n = cb << lg;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t k = blockIdx.x;
  const int h = clampi(th[k], 0, cb), w = clampi(tw[k], 0, cb);
  const int16_t* tile = tiles + k * n;

  // 1. the tile, read once: masked magnitudes, their max, d0
  uint32_t mx = 0;
  unsigned long long d0 = 0;
  auto magnitude = [&](int i, int v) -> uint32_t {
    const int y = i >> lg, x = i & (cb - 1);
    const uint32_t m = y < h && x < w ? static_cast<uint32_t>(abs(v)) : 0u;
    mx = max(mx, m);
    d0 += m * m;                      // <= 2^30: exact in uint32
    return m;
  };
  if (vec) {                          // n % 8 == 0, 16-byte aligned tiles
    const uint4* src = reinterpret_cast<const uint4*>(tile);
    uint4* dst = reinterpret_cast<uint4*>(mag);
    for (int j = t; j < n / 8; j += kThreads) {
      const uint4 raw = __ldg(src + j);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * e;
        out[e] = magnitude(i, static_cast<int16_t>(in[e] & 0xffffu)) |
                 magnitude(i + 1, static_cast<int16_t>(in[e] >> 16)) << 16;
      }
      dst[j] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  } else {
    for (int i = t; i < n; i += kThreads) mag[i] = magnitude(i, tile[i]);
  }
  mx = __reduce_max_sync(kFull, mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d0 += __shfl_xor_sync(kFull, d0, o);
  if (lane == 0) {
    warp_max[warp] = mx;
    warp_d0[warp] = d0;
  }
  __syncthreads();
  mx = 0;
  d0 = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    mx = max(mx, warp_max[i]);
    d0 += warp_d0[i];
  }
  const int msbs = 32 - __clz(mx);
  if (msbs == 0) {                    // all zero: no pass codes anything
    if (t == 0) {
      smax_out[k] = 0.0f;
      d0_out[k] = 0.0f;
    }
    return;
  }

  // 2. one mask per row and plane: bit x = column x
  for (int y = warp; y < cb; y += kWarps) {
    const uint32_t m0 = lane < cb ? mag[(y << lg) + lane] : 0u;
    const uint32_t m1 = lane + 32 < cb ? mag[(y << lg) + lane + 32] : 0u;
    for (int q = 0; q < msbs; ++q) {
      const uint64_t lo = __ballot_sync(kFull, (m0 >> q) & 1u);
      const uint64_t hi = __ballot_sync(kFull, (m1 >> q) & 1u);
      if (lane == 0) plane_rows[q][y] = lo | hi << 32;
    }
  }
  __syncthreads();

  // 3. the planes, one row a thread
  const int y = t;
  const bool in = y < cb;
  const uint64_t valid = y < h ? (w == 64 ? ~0ull : (1ull << w) - 1) : 0;
  uint64_t sig_up = 0, sig = 0, sig_dn = 0;   // significance entering p
  for (int p = msbs - 1; p >= 0; --p) {
    const uint64_t bits = in ? plane_rows[p][y] : 0;
    const uint64_t bits_up = in && y > 0 ? plane_rows[p][y - 1] : 0;
    const uint64_t bits_dn = y + 1 < cb ? plane_rows[p][y + 1] : 0;
    const uint64_t around = sig_up | sig | sig_dn;
    const uint64_t nbr =
        ((around << 1) | (around >> 1) | sig_up | sig_dn) & valid;
    const uint64_t fresh = bits & ~sig;        // bits lie inside valid
    const uint64_t spp_ones = fresh & nbr, cp_ones = fresh & ~nbr;
    const uint64_t mr_ones = bits & sig, mr_zeros = sig & ~bits;
    const uint64_t cp_members = ~sig & ~nbr & valid;
    int32_t rest_spp = 0, rest_cp = 0, rest1 = 0, rest0 = 0;
    for (int q = 0; q < (in ? p : 0); ++q) {
      const uint64_t b = plane_rows[q][y];
      rest_spp += __popcll(b & spp_ones) << q;
      rest_cp += __popcll(b & cp_ones) << q;
      rest1 += __popcll(b & mr_ones) << q;
      rest0 += __popcll(b & mr_zeros) << q;
    }
    // cleanup: members and ones of the stripe of 4 rows (lanes 4s..4s+3)
    uint32_t group = __popcll(cp_members) | __popcll(cp_ones) << 16;
    group += __shfl_xor_sync(kFull, group, 1);
    group += __shfl_xor_sync(kFull, group, 2);
    const int members = group & 0xffffu, ones = group >> 16;
    const int cp_bits = (lane & 3) == 0 && members > 0
                            ? 1 + (ones > 0 ? members + ones : 0) : 0;
    const int32_t v[kStats] = {
        __popcll(nbr & ~sig), __popcll(spp_ones), rest_spp,
        __popcll(mr_ones), rest1, __popcll(mr_zeros), rest0,
        __popcll(cp_ones), rest_cp, cp_bits};
#pragma unroll
    for (int s = 0; s < kStats; ++s) {
      const int32_t total = __reduce_add_sync(kFull, v[s]);
      if (lane == 0) stats[p][s][warp] = total;
    }
    sig |= bits;                               // updates at plane end
    sig_up |= bits_up;
    sig_dn |= bits_dn;
  }
  __syncthreads();
  if (t != 0) return;

  // 4. the passes in coding order, the plain version's float32 prefix
  const float d0f = __ull2float_rn(d0);
  float ends = 0.0f, cum = 0.0f, best = 0.0f;
  for (int p = msbs - 1; p >= 0; --p) {
    int64_t s[kStats];
#pragma unroll
    for (int i = 0; i < kStats; ++i) {
      s[i] = 0;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) s[i] += stats[p][i][j];
    }
    const int64_t nbits[3] = {s[kSppMembers] + s[kSppOnes],
                              s[kMrOnes] + s[kMrZeros], s[kCpBits]};
    const int64_t dsse[3] = {
        fresh_dsse(p, s[kSppOnes], s[kSppRest]),
        refine_dsse(p, s[kMrOnes], s[kMrOnesRest], s[kMrZeros],
                    s[kMrZerosRest]),
        fresh_dsse(p, s[kCpOnes], s[kCpRest])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ends = __fadd_rn(ends, static_cast<float>((nbits[i] + 7) >> 3));
      cum = __fadd_rn(cum, __ll2float_rn(dsse[i]));
      const float sse = __fadd_rn(d0f, cum);
      const float slope =
          ends > 0.0f ? __fdiv_rn(__fsub_rn(d0f, sse), fmaxf(ends, 1.0f))
                      : 0.0f;
      best = fmaxf(best, slope);
    }
  }
  smax_out[k] = best;
  d0_out[k] = d0f;
}

}  // namespace

extern "C" int qsvc_bp_slope(const void* tiles, const void* th,
                             const void* tw, void* smax, void* d0, int K,
                             int cb, void* stream) {
  int lg = 0;
  while ((1 << lg) < cb) ++lg;
  // 16-byte loads: whole 8-element groups in each tile, aligned stack
  const bool vec = cb * cb % 8 == 0 && aligned16(tiles);
  bp_slope_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tiles), static_cast<const int32_t*>(th),
      static_cast<const int32_t*>(tw), lg, vec, static_cast<float*>(smax),
      static_cast<float*>(d0));
  return static_cast<int>(cudaGetLastError());
}
