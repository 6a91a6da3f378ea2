// EBCOT Tier-1 + MQ coder — native fast path (C ABI, OpenMP batch).
//
// Algorithmically identical to the Python reference implementation in
// qsvc_tpu/codec/{mq,tier1}.py (same T.88 state machine, same guarded
// flush, same pass structure and scan order); the Python tests assert
// bit-exact agreement of the coded bytes between the two.  This is the
// framework's native replacement for the entropy coding the reference
// delegates to the closed-source Kakadu binaries
// (texture_compress_fb_j2k.py:183-196).
//
// Fast-path engineering (vs the straightforward per-coefficient version):
//  * one uint16 "flags" word per coefficient in a border-padded lattice,
//    caching the 8-neighbour significance bits + 4 NSEW neighbour sign
//    bits + SIG/VIS/REF/SGN of the coefficient itself — updated on the
//    fly when a coefficient becomes significant, so every context lookup
//    is one load + one table index instead of 9 bounds-checked loads;
//  * 256-entry significance-context LUT per band family and a 256-entry
//    sign-context LUT (context | xorbit<<5);
//  * incremental distortion tracking (SSE updated per coding event)
//    instead of a full-block rescan after every pass;
//  * strided input/output variants so whole packed DWT planes can be
//    passed once from Python with zero per-tile copies;
//  * OpenMP across code-blocks (each block's MQ stream is independent).
//
// Build: g++ -O3 -fopenmp -shared -fPIC ebcot.cpp -o libqsvc.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__BMI2__)
#include <immintrin.h>
static inline uint64_t pext64(uint64_t x, uint64_t m) { return _pext_u64(x, m); }
static inline uint64_t pdep64(uint64_t x, uint64_t m) { return _pdep_u64(x, m); }
#else
static inline uint64_t pext64(uint64_t x, uint64_t m) {
  uint64_t r = 0; int k = 0;
  while (m) { uint64_t b = m & -m; if (x & b) r |= 1ull << k; k++; m &= m - 1; }
  return r;
}
static inline uint64_t pdep64(uint64_t x, uint64_t m) {
  uint64_t r = 0; int k = 0;
  while (m) { uint64_t b = m & -m; if ((x >> k) & 1) r |= b; k++; m &= m - 1; }
  return r;
}
#endif

namespace {

// ---------------------------------------------------------------- MQ tables
struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };
static const QeRow QE[47] = {
  {0x5601,1,1,1},{0x3401,2,6,0},{0x1801,3,9,0},{0x0AC1,4,12,0},
  {0x0521,5,29,0},{0x0221,38,33,0},{0x5601,7,6,1},{0x5401,8,14,0},
  {0x4801,9,14,0},{0x3801,10,14,0},{0x3001,11,17,0},{0x2401,12,18,0},
  {0x1C01,13,20,0},{0x1601,29,21,0},{0x5601,15,14,1},{0x5401,16,14,0},
  {0x5101,17,15,0},{0x4801,18,16,0},{0x3801,19,17,0},{0x3401,20,18,0},
  {0x3001,21,19,0},{0x2801,22,19,0},{0x2401,23,20,0},{0x2201,24,21,0},
  {0x1C01,25,22,0},{0x1801,26,23,0},{0x1601,27,24,0},{0x1401,28,25,0},
  {0x1201,29,26,0},{0x1101,30,27,0},{0x0AC1,31,28,0},{0x09C1,32,29,0},
  {0x08A1,33,30,0},{0x0521,34,31,0},{0x0441,35,32,0},{0x02A1,36,33,0},
  {0x0221,37,34,0},{0x0141,38,35,0},{0x0111,39,36,0},{0x0085,40,37,0},
  {0x0049,41,38,0},{0x0025,42,39,0},{0x0015,43,40,0},{0x0009,44,41,0},
  {0x0005,45,42,0},{0x0001,45,43,0},{0x5601,46,46,0},
};

constexpr int N_CTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;

struct Ctx { uint8_t idx, mps; };

static void init_ctx(Ctx* c) {
  for (int i = 0; i < N_CTX; i++) { c[i].idx = 0; c[i].mps = 0; }
  c[0].idx = 4; c[CTX_RL].idx = 3; c[CTX_UNI].idx = 46;
}

// ---------------------------------------------------------------- encoder
struct MQEnc {
  Ctx ctx[N_CTX];
  uint32_t a, c;
  int ct, b;                      // b = -1: none staged
  std::vector<uint8_t> out;       // committed bytes
  std::vector<uint8_t> pending;

  MQEnc() { init_ctx(ctx); reset_interval(); }
  void reset_interval() { a = 0x8000; c = 0; ct = 12; b = -1; pending.clear(); }

  void push() { if (b >= 0) pending.push_back((uint8_t)b); }

  void byteout() {
    if (b == 0xFF) {
      push(); b = (c >> 20) & 0xFF; c &= 0xFFFFF; ct = 7;
    } else if (c < 0x8000000u) {
      push(); b = (c >> 19) & 0xFF; c &= 0x7FFFF; ct = 8;
    } else {
      b += 1;
      if (b == 0xFF) {
        c &= 0x7FFFFFF; push(); b = (c >> 20) & 0xFF; c &= 0xFFFFF; ct = 7;
      } else {
        push(); b = (c >> 19) & 0xFF; c &= 0x7FFFF; ct = 8;
      }
    }
  }

  void renorm() {
    do {
      if (ct == 0) byteout();
      a = (a << 1) & 0xFFFF;
      c = (c << 1) & 0xFFFFFFF;
      ct--;
    } while (!(a & 0x8000));
  }

  void encode(int bit, int cx) {
    Ctx& s = ctx[cx];
    const QeRow& q = QE[s.idx];
    a -= q.qe;
    if (bit == s.mps) {
      if (a & 0x8000) { c += q.qe; }
      else {
        if (a < q.qe) a = q.qe; else c += q.qe;
        s.idx = q.nmps;
        renorm();
      }
    } else {
      if (a < q.qe) c += q.qe; else a = q.qe;
      if (q.sw) s.mps = 1 - s.mps;
      s.idx = q.nlps;
      renorm();
    }
  }

  // guarded flush (see qsvc_tpu/codec/mq.py flush docstring)
  int flush() {
    int p = 13 - ct; if (p < 0) p = 0;
    uint64_t tempc64 = (uint64_t)c + a - 1;
    int64_t t = (int64_t)tempc64 - ((int64_t)1 << (p + 1));
    uint32_t tempc = (uint32_t)((t >> p) << p);
    if (c < tempc) c = tempc;
    c = (c << ct) & 0xFFFFFFF; byteout();
    c = (c << ct) & 0xFFFFFFF; byteout();
    if (b != 0xFF && b >= 0) pending.push_back((uint8_t)b);
    out.insert(out.end(), pending.begin(), pending.end());
    if (!out.empty() && out.back() == 0xFF) out.pop_back();
    reset_interval();
    return (int)out.size();
  }
};

// ---------------------------------------------------------------- decoder
struct MQDec {
  Ctx ctx[N_CTX];
  const uint8_t* data;
  int bp, end, datalen;
  uint32_t a, c; int ct, b;

  MQDec(const uint8_t* d, int n) : data(d), bp(0), end(n), datalen(n) {
    init_ctx(ctx);
  }
  int byte(int i) const { return i < end ? data[i] : 0xFF; }

  void start_segment(int s, int e) {
    bp = s; end = e < datalen ? e : datalen;
    b = byte(bp);
    c = (uint32_t)b << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }

  void bytein() {
    if (b == 0xFF) {
      if (byte(bp + 1) > 0x8F) { c += 0xFF00; ct = 8; }
      else { bp++; b = byte(bp); c += (uint32_t)b << 9; ct = 7; }
    } else {
      bp++; b = byte(bp); c += (uint32_t)b << 8; ct = 8;
    }
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct--;
    } while (!(a & 0x8000));
  }

  int decode(int cx) {
    Ctx& s = ctx[cx];
    const QeRow& q = QE[s.idx];
    int d;
    a -= q.qe;
    uint32_t chigh = (c >> 16) & 0xFFFF;
    if (chigh < q.qe) {
      if (a < q.qe) { d = s.mps; s.idx = q.nmps; }
      else {
        d = 1 - s.mps;
        if (q.sw) s.mps = 1 - s.mps;
        s.idx = q.nlps;
      }
      a = q.qe;
      renorm();
    } else {
      c -= (uint32_t)q.qe << 16;
      if (!(a & 0x8000)) {
        if (a < q.qe) {
          d = 1 - s.mps;
          if (q.sw) s.mps = 1 - s.mps;
          s.idx = q.nlps;
        } else { d = s.mps; s.idx = q.nmps; }
        renorm();
      } else d = s.mps;
    }
    return d;
  }
};

// ----------------------------------------------------------- Tier-1 common

// band codes: 0 = LL/LH family, 1 = HL (transpose), 2 = HH
static inline int sig_ctx_ref(int h, int v, int d, int band) {
  if (band == 1) { int t = h; h = v; v = t; }
  if (band != 2) {
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : d;
  }
  int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : hv;
}

// sign context + xor from clipped (h, v) in {-1,0,1}
static inline void sign_ctx_ref(int h, int v, int* cx, int* xr) {
  if (h == 0 && v == 0) { *cx = 9; *xr = 0; }
  else if (h == 0) { *cx = 10; *xr = v < 0; }
  else if (h == 1) { *cx = v == 1 ? 13 : (v == 0 ? 12 : 11); *xr = 0; }
  else { *cx = v == 1 ? 11 : (v == 0 ? 12 : 13); *xr = 1; }
}

// Flag-word layout (one uint16 per coefficient, border-padded lattice):
//   bits 0..7  neighbour significance: NW N NE W E SW S SE
//   bits 8..11 neighbour signs (1 = negative): N S W E
//   bit 12 SIG, bit 13 VIS, bit 14 REF, bit 15 SGN (own sign)
constexpr uint16_t F_NW = 1 << 0, F_N = 1 << 1, F_NE = 1 << 2;
constexpr uint16_t F_W  = 1 << 3, F_E = 1 << 4;
constexpr uint16_t F_SW = 1 << 5, F_S = 1 << 6, F_SE = 1 << 7;
constexpr uint16_t F_SGN_N = 1 << 8, F_SGN_S = 1 << 9;
constexpr uint16_t F_SGN_W = 1 << 10, F_SGN_E = 1 << 11;
constexpr uint16_t F_SIG = 1 << 12, F_VIS = 1 << 13;
constexpr uint16_t F_REF = 1 << 14, F_SGN = 1 << 15;
constexpr uint16_t F_NBR = 0x00FF;

struct Luts {
  uint8_t sig[3][256];
  uint8_t sign[256];   // (cx | xr<<5) keyed by sigN|sigS<<1|sigW<<2|sigE<<3
                       //              | sgnN<<4|sgnS<<5|sgnW<<6|sgnE<<7
  Luts() {
    for (int band = 0; band < 3; band++)
      for (int b = 0; b < 256; b++) {
        int h = ((b >> 3) & 1) + ((b >> 4) & 1);
        int v = ((b >> 1) & 1) + ((b >> 6) & 1);
        int d = (b & 1) + ((b >> 2) & 1) + ((b >> 5) & 1) + ((b >> 7) & 1);
        sig[band][b] = (uint8_t)sig_ctx_ref(h, v, d, band);
      }
    for (int b = 0; b < 256; b++) {
      auto con = [&](int sig_bit, int sgn_bit) -> int {
        if (!((b >> sig_bit) & 1)) return 0;
        return ((b >> sgn_bit) & 1) ? -1 : 1;
      };
      int hh = con(2, 6) + con(3, 7);   // W + E
      int vv = con(0, 4) + con(1, 5);   // N + S
      int hc = hh > 1 ? 1 : (hh < -1 ? -1 : hh);
      int vc = vv > 1 ? 1 : (vv < -1 ? -1 : vv);
      int cx, xr;
      sign_ctx_ref(hc, vc, &cx, &xr);
      sign[b] = (uint8_t)(cx | (xr << 5));
    }
  }
};
static const Luts LUT;

static inline int sign_lut_index(uint16_t f) {
  return ((f >> 1) & 1) | (((f >> 6) & 1) << 1) |
         (((f >> 3) & 1) << 2) | (((f >> 4) & 1) << 3) |
         (((f >> 8) & 0xF) << 4);
}

struct T1Lattice {
  int h, w, w2;
  std::vector<uint16_t> fl;  // (h+2) x (w+2), border-padded
  T1Lattice(int h_, int w_) : h(h_), w(w_), w2(w_ + 2),
                              fl((h_ + 2) * (w_ + 2), 0) {}
  inline uint16_t* at(int y, int x) { return &fl[(y + 1) * w2 + (x + 1)]; }
  inline void set_sig(int y, int x, int neg) {
    uint16_t* p = at(y, x);
    p[0] |= F_SIG | (neg ? F_SGN : 0);
    p[-w2 - 1] |= F_SE;
    p[-w2]     |= (uint16_t)(F_S | (neg ? F_SGN_S : 0));
    p[-w2 + 1] |= F_SW;
    p[-1]      |= (uint16_t)(F_E | (neg ? F_SGN_E : 0));
    p[+1]      |= (uint16_t)(F_W | (neg ? F_SGN_W : 0));
    p[w2 - 1]  |= F_NE;
    p[w2]      |= (uint16_t)(F_N | (neg ? F_SGN_N : 0));
    p[w2 + 1]  |= F_NW;
  }
  void clear_vis() {
    // VIS bits only ever set on interior cells
    for (size_t i = 0; i < fl.size(); i++) fl[i] &= (uint16_t)~F_VIS;
  }
};

// reconstruction value of magnitude m truncated at plane p (spec mid-point)
static inline int64_t recon(int64_t m, int p) {
  int64_t half = p > 0 ? (int64_t)1 << (p - 1) : 0;
  return ((m >> p) << p) + half;
}

// -------------------------------------------------------------- encoder T1
//
// Templated on the (possibly strided) coefficient reader so packed DWT
// planes can be coded in place.
template <typename T>
static int encode_block_impl(const T* coeffs, int stride, int h, int w,
                             int band, uint8_t* out_buf, int out_cap,
                             int* msbs_out, int* n_passes_out,
                             int* pass_ends, double* pass_dist,
                             double* dist0, double min_slope) {
  const int n = h * w;
  std::vector<int32_t> mag(n);
  std::vector<uint8_t> neg(n);
  int32_t mx = 0;
  double d0 = 0.0;
  for (int y = 0; y < h; y++) {
    const T* row = coeffs + (size_t)y * stride;
    for (int x = 0; x < w; x++) {
      int32_t v = (int32_t)row[x];
      int32_t m = v < 0 ? -v : v;
      mag[y * w + x] = m;
      neg[y * w + x] = v < 0;
      if (m > mx) mx = m;
      d0 += (double)m * (double)m;
    }
  }
  *dist0 = d0;
  int msbs = 0; while (mx >> msbs) msbs++;
  *msbs_out = msbs;
  if (msbs == 0) { *n_passes_out = 0; return 0; }

  T1Lattice st(h, w);
  MQEnc enc;
  int np = 0;
  double sse = d0;   // incrementally tracked SSE (== distortion() rescan)
  const uint8_t* SIGLUT = LUT.sig[band];

  auto code_sign = [&](int y, int x, int ng) {
    uint16_t f = *st.at(y, x);
    uint8_t s = LUT.sign[sign_lut_index(f)];
    enc.encode(ng ^ (s >> 5), s & 0x1F);
  };

  auto become_sig = [&](int y, int x, int i, int plane) {
    int ng = neg[i];
    // sign context must be computed BEFORE the neighbour update
    code_sign(y, x, ng);
    st.set_sig(y, x, ng);
    double m = (double)mag[i];
    double e = m - (double)recon(mag[i], plane);
    sse += e * e - m * m;
  };

  auto sig_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        for (int r = 0; r < rows; r++) {
          uint16_t f = col[r * st.w2];
          if (f & F_SIG) continue;
          if (!(f & F_NBR)) continue;
          int y = y0 + r, i = y * w + x;
          int b = (mag[i] & bit) ? 1 : 0;
          enc.encode(b, SIGLUT[f & 0xFF]);
          if (b) become_sig(y, x, i, plane);
          col[r * st.w2] |= F_VIS;
        }
      }
    }
  };

  auto mag_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        for (int r = 0; r < rows; r++) {
          uint16_t f = col[r * st.w2];
          if (!(f & F_SIG) || (f & F_VIS)) continue;
          int i = (y0 + r) * w + x;
          int cx = (f & F_REF) ? 16 : ((f & F_NBR) ? 15 : 14);
          enc.encode((mag[i] & bit) ? 1 : 0, cx);
          col[r * st.w2] |= F_REF | F_VIS;
          double m = (double)mag[i];
          double eo = m - (double)recon(mag[i], plane + 1);
          double en = m - (double)recon(mag[i], plane);
          sse += en * en - eo * eo;
        }
      }
    }
  };

  auto cleanup_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        int r = 0;
        bool rl = rows == 4
            && !(col[0] & (F_SIG | F_VIS | F_NBR))
            && !(col[st.w2] & (F_SIG | F_VIS | F_NBR))
            && !(col[2 * st.w2] & (F_SIG | F_VIS | F_NBR))
            && !(col[3 * st.w2] & (F_SIG | F_VIS | F_NBR));
        if (rl) {
          int first = -1;
          for (int k = 0; k < 4; k++)
            if (mag[(y0 + k) * w + x] & bit) { first = k; break; }
          if (first < 0) { enc.encode(0, CTX_RL); continue; }
          enc.encode(1, CTX_RL);
          enc.encode((first >> 1) & 1, CTX_UNI);
          enc.encode(first & 1, CTX_UNI);
          int y = y0 + first;
          become_sig(y, x, y * w + x, plane);
          r = first + 1;
        }
        for (int k = r; k < rows; k++) {
          uint16_t f = col[k * st.w2];
          if (f & (F_SIG | F_VIS)) continue;
          int y = y0 + k, i = y * w + x;
          int b = (mag[i] & bit) ? 1 : 0;
          enc.encode(b, SIGLUT[f & 0xFF]);
          if (b) become_sig(y, x, i, plane);
        }
      }
    }
    st.clear_vis();
  };

  cleanup_pass(msbs - 1);
  pass_ends[np] = enc.flush();
  pass_dist[np++] = sse;
  for (int plane = msbs - 2; plane >= 0; plane--) {
    sig_pass(plane);
    pass_ends[np] = enc.flush();
    pass_dist[np++] = sse;
    mag_pass(plane);
    pass_ends[np] = enc.flush();
    pass_dist[np++] = sse;
    cleanup_pass(plane);
    pass_ends[np] = enc.flush();
    pass_dist[np++] = sse;
    // early stop: once a whole plane's distortion-length slope falls below
    // min_slope, deeper planes (with ~4x smaller slopes) cannot be kept by
    // any truncation at that threshold — skip coding them entirely.
    if (min_slope > 0 && np >= 4) {
      double dD = pass_dist[np - 4] - pass_dist[np - 1];
      double dR = (double)(pass_ends[np - 1] - pass_ends[np - 4]);
      if (dR > 0 && dD / dR < min_slope) break;
    }
  }
  *n_passes_out = np;
  int total = (int)enc.out.size();
  if (total > out_cap) return -1;
  std::memcpy(out_buf, enc.out.data(), total);
  return total;
}

// -------------------------------------------------------------- decoder T1
template <typename OutT>
static int decode_block_impl(const uint8_t* data, int len, int msbs,
                             int n_passes, const int* pass_ends,
                             int n_pass_ends, int h, int w, int band,
                             OutT* out, int ostride) {
  for (int y = 0; y < h; y++)
    std::memset(out + (size_t)y * ostride, 0, w * sizeof(OutT));
  if (msbs == 0 || n_passes == 0) return 0;
  const int n = h * w;
  std::vector<int32_t> val(n, 0);
  T1Lattice st(h, w);
  MQDec dec(data, len);
  const uint8_t* SIGLUT = LUT.sig[band];

  auto seg = [&](int i) {
    int s = i == 0 ? 0 : pass_ends[i - 1];
    int e = i < n_pass_ends ? pass_ends[i] : len;
    dec.start_segment(s, e);
  };

  auto decode_sig = [&](int y, int x, int i, int32_t bit) {
    uint16_t f = *st.at(y, x);
    uint8_t s = LUT.sign[sign_lut_index(f)];
    int ng = dec.decode(s & 0x1F) ^ (s >> 5);
    val[i] |= bit;
    st.set_sig(y, x, ng);
  };

  auto sig_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        for (int r = 0; r < rows; r++) {
          uint16_t f = col[r * st.w2];
          if (f & F_SIG) continue;
          if (!(f & F_NBR)) continue;
          int y = y0 + r, i = y * w + x;
          if (dec.decode(SIGLUT[f & 0xFF])) decode_sig(y, x, i, bit);
          col[r * st.w2] |= F_VIS;
        }
      }
    }
  };

  auto mag_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        for (int r = 0; r < rows; r++) {
          uint16_t f = col[r * st.w2];
          if (!(f & F_SIG) || (f & F_VIS)) continue;
          int i = (y0 + r) * w + x;
          int cx = (f & F_REF) ? 16 : ((f & F_NBR) ? 15 : 14);
          if (dec.decode(cx)) val[i] |= bit;
          col[r * st.w2] |= F_REF | F_VIS;
        }
      }
    }
  };

  auto cleanup_pass = [&](int plane) {
    const int32_t bit = (int32_t)1 << plane;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      for (int x = 0; x < w; x++) {
        uint16_t* col = st.at(y0, x);
        int r = 0;
        bool rl = rows == 4
            && !(col[0] & (F_SIG | F_VIS | F_NBR))
            && !(col[st.w2] & (F_SIG | F_VIS | F_NBR))
            && !(col[2 * st.w2] & (F_SIG | F_VIS | F_NBR))
            && !(col[3 * st.w2] & (F_SIG | F_VIS | F_NBR));
        if (rl) {
          if (!dec.decode(CTX_RL)) continue;
          int first = (dec.decode(CTX_UNI) << 1) | dec.decode(CTX_UNI);
          int y = y0 + first;
          decode_sig(y, x, y * w + x, bit);
          r = first + 1;
        }
        for (int k = r; k < rows; k++) {
          uint16_t f = col[k * st.w2];
          if (f & (F_SIG | F_VIS)) continue;
          int y = y0 + k, i = y * w + x;
          if (dec.decode(SIGLUT[f & 0xFF])) decode_sig(y, x, i, bit);
        }
      }
    }
    st.clear_vis();
  };

  seg(0);
  cleanup_pass(msbs - 1);
  int pass_idx = 1, plane = msbs - 1;
  bool after_spp = false;
  int p = msbs - 2;
  while (p >= 0 && pass_idx < n_passes) {
    seg(pass_idx); sig_pass(p); pass_idx++; plane = p;
    if (pass_idx >= n_passes) { after_spp = true; break; }
    seg(pass_idx); mag_pass(p); pass_idx++;
    if (pass_idx >= n_passes) break;
    seg(pass_idx); cleanup_pass(p); pass_idx++;
    p--;
  }

  for (int y = 0; y < h; y++) {
    OutT* orow = out + (size_t)y * ostride;
    for (int x = 0; x < w; x++) {
      uint16_t f = *st.at(y, x);
      if (!(f & F_SIG)) continue;
      int i = y * w + x;
      int u = (after_spp && !(f & F_VIS)) ? plane + 1 : plane;
      int32_t half = u > 0 ? ((int32_t)1 << u) >> 1 : 0;
      int32_t rec = val[i] + half;
      orow[x] = (OutT)((f & F_SGN) ? -rec : rec);
    }
  }
  return 0;
}

// ------------------------------------------------------------ BP coder
//
// Bit-parallel block coder ("bp") — the framework's throughput-oriented
// alternative to the MQ path, built for 64-coefficients-per-instruction
// row processing (uint64 row masks + PEXT/PDEP).  It makes the same
// relaxations JPEG2000's arithmetic-coder-bypass mode makes (raw
// significance/refinement bits) plus frozen-per-plane pass membership, in
// exchange for ~50x encode throughput; the MQ path remains the
// spec-style/maximum-compaction mode.  Stream structure per code-block
// (h, w <= 64):
//
//   for plane p = msbs-1 .. 0, three byte-aligned passes:
//     SPP: members = ~sig & nbr(sig) & valid  (sig frozen at plane start)
//          payload: member bits (row-major raster), then the sign bits of
//          the members whose bit was 1 (same order)
//     MRP: members = sig & valid; payload: member bits (raw refinement)
//     CP : members = ~sig & ~nbr & valid; per 4-row stripe with >=1
//          member: 1 occupancy bit (any member bit set in the stripe);
//          if 1: per row member bits, then sign bits of the 1s
//   significance state updates only at plane end (sig |= plane bits), so
//   encoder and decoder derive identical membership with no serial
//   intra-pass dependency — the property that lets the passes run as
//   whole-row mask operations (and, later, as device-side vector ops).
//
// Pass boundaries, pass_ends, distortion recording and min_slope early
// stop are identical to the MQ path, so quality-layer formation and
// QS/SS/TS extraction are coder-agnostic.

namespace bp {

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0; int nbits = 0;
  inline void put(uint64_t bits, int n) {
    while (n > 32) { put(bits & 0xFFFFFFFFull, 32); bits >>= 32; n -= 32; }
    if (!n) return;
    acc |= (bits & ((n == 64) ? ~0ull : ((1ull << n) - 1))) << nbits;
    nbits += n;
    while (nbits >= 8) { buf.push_back((uint8_t)acc); acc >>= 8; nbits -= 8; }
  }
  inline void align() {
    if (nbits) { buf.push_back((uint8_t)acc); acc = 0; nbits = 0; }
  }
};

struct BitReader {
  const uint8_t* data; int len; int pos = 0;  // byte position
  uint64_t acc = 0; int nbits = 0;
  BitReader(const uint8_t* d, int l) : data(d), len(l) {}
  inline uint64_t get(int n) {
    uint64_t out = 0; int got = 0;
    while (got < n) {
      if (nbits == 0) {
        acc = pos < len ? data[pos] : 0; pos++; nbits = 8;
      }
      int take = n - got < nbits ? n - got : nbits;
      out |= (acc & ((1ull << take) - 1)) << got;
      acc >>= take; nbits -= take; got += take;
    }
    return out;
  }
  inline void align() { nbits = 0; acc = 0; }
  inline bool exhausted() const { return pos > len; }
};

template <typename T>
static int encode_block(const T* coeffs, int stride, int h, int w,
                        uint8_t* out_buf, int out_cap,
                        int* msbs_out, int* n_passes_out,
                        int* pass_ends, double* pass_dist, double* dist0,
                        double min_slope) {
  uint64_t bprow[32][64];   // [plane][row] bit masks
  uint64_t sgn[64], validr[64], sig[64], nbr[64];
  int32_t mag[64 * 64];
  std::memset(bprow, 0, sizeof(bprow));
  std::memset(sgn, 0, sizeof(sgn));
  const uint64_t colmask = w >= 64 ? ~0ull : ((1ull << w) - 1);
  int32_t mx = 0;
  double d0 = 0.0;
  for (int y = 0; y < h; y++) {
    const T* row = coeffs + (size_t)y * stride;
    validr[y] = colmask;
    for (int x = 0; x < w; x++) {
      int32_t v = (int32_t)row[x];
      int32_t m = v < 0 ? -v : v;
      mag[y * 64 + x] = m;
      if (v < 0) sgn[y] |= 1ull << x;
      if (m > mx) mx = m;
      d0 += (double)m * (double)m;
      for (int32_t mm = m; mm; mm &= mm - 1)
        bprow[__builtin_ctz(mm)][y] |= 1ull << x;
    }
  }
  for (int y = h; y < 64; y++) validr[y] = 0;
  *dist0 = d0;
  int msbs = 0; while (mx >> msbs) msbs++;
  *msbs_out = msbs;
  if (msbs == 0) { *n_passes_out = 0; return 0; }

  std::memset(sig, 0, sizeof(sig));
  BitWriter wr;
  double sse = d0;
  int np = 0;

  auto newly_delta = [&](uint64_t ones, int y, int p) {
    while (ones) {
      int x = __builtin_ctzll(ones); ones &= ones - 1;
      double m = (double)mag[y * 64 + x];
      int32_t mm = mag[y * 64 + x];
      int32_t rec = ((mm >> p) << p) + (p > 0 ? 1 << (p - 1) : 0);
      double e = m - (double)rec;
      sse += e * e - m * m;
    }
  };

  for (int p = msbs - 1; p >= 0; p--) {
    // frozen neighbourhood of the plane-start significance state
    for (int y = 0; y < h; y++) {
      uint64_t up = y > 0 ? sig[y - 1] : 0;
      uint64_t dn = y + 1 < h ? sig[y + 1] : 0;
      uint64_t t = up | sig[y] | dn;
      nbr[y] = ((t << 1) | (t >> 1) | up | dn) & colmask;
    }
    const uint64_t* bits = bprow[p];

    // ---- significance propagation
    for (int y = 0; y < h; y++) {
      uint64_t mem = ~sig[y] & nbr[y] & validr[y];
      wr.put(pext64(bits[y], mem), __builtin_popcountll(mem));
    }
    for (int y = 0; y < h; y++) {
      uint64_t ones = bits[y] & ~sig[y] & nbr[y] & validr[y];
      wr.put(pext64(sgn[y], ones), __builtin_popcountll(ones));
      newly_delta(ones, y, p);
    }
    wr.align();
    pass_ends[np] = (int)wr.buf.size();
    pass_dist[np++] = sse;

    // ---- magnitude refinement (raw bits)
    //
    // SSE delta over the refined set in closed form via bit-plane
    // popcounts: with v = K*2^{p+1} + b*2^p + r and h = 2^{p-1},
    //   b=1: d = h^2 - 2hr,   b=0: d = 2hr - 3h^2   (p > 0)
    //   p=0: d = -[b == 0]
    // and sum(r over masked set) = sum_q 2^q popcount(bprow[q] & set).
    {
      int64_t n1 = 0, n0 = 0, s1 = 0, s0 = 0;
      for (int y = 0; y < h; y++) {
        uint64_t mem = sig[y] & validr[y];
        if (!mem) continue;
        wr.put(pext64(bits[y], mem), __builtin_popcountll(mem));
        uint64_t ones = bits[y] & mem, zeros = mem & ~bits[y];
        n1 += __builtin_popcountll(ones);
        n0 += __builtin_popcountll(zeros);
        for (int q = 0; q < p; q++) {
          s1 += (int64_t)__builtin_popcountll(bprow[q][y] & ones) << q;
          s0 += (int64_t)__builtin_popcountll(bprow[q][y] & zeros) << q;
        }
      }
      if (p > 0) {
        int64_t hh = (int64_t)1 << (p - 1);
        sse += (double)(hh * hh * (n1 - 3 * n0) + 2 * hh * (s0 - s1));
      } else {
        sse -= (double)n0;
      }
    }
    wr.align();
    pass_ends[np] = (int)wr.buf.size();
    pass_dist[np++] = sse;

    // ---- cleanup (stripe group testing)
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      uint64_t any_mem = 0, any_one = 0;
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        uint64_t mem = ~sig[y] & ~nbr[y] & validr[y];
        any_mem |= mem;
        any_one |= bits[y] & mem;
      }
      if (!any_mem) continue;
      wr.put(any_one ? 1 : 0, 1);
      if (!any_one) continue;
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        uint64_t mem = ~sig[y] & ~nbr[y] & validr[y];
        wr.put(pext64(bits[y], mem), __builtin_popcountll(mem));
      }
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        uint64_t ones = bits[y] & ~sig[y] & ~nbr[y] & validr[y];
        wr.put(pext64(sgn[y], ones), __builtin_popcountll(ones));
        newly_delta(ones, y, p);
      }
    }
    wr.align();
    pass_ends[np] = (int)wr.buf.size();
    pass_dist[np++] = sse;

    // significance updates at plane end only
    for (int y = 0; y < h; y++) sig[y] |= bits[y];

    if (min_slope > 0 && np >= 4) {
      double dD = pass_dist[np - 4] - pass_dist[np - 1];
      double dR = (double)(pass_ends[np - 1] - pass_ends[np - 4]);
      if (dR > 0 && dD / dR < min_slope) break;
    }
  }
  *n_passes_out = np;
  int total = (int)wr.buf.size();
  if (total > out_cap) return -1;
  std::memcpy(out_buf, wr.buf.data(), total);
  return total;
}

template <typename OutT>
static int decode_block(const uint8_t* data, int len, int msbs, int n_passes,
                        int h, int w, OutT* out, int ostride) {
  for (int y = 0; y < h; y++)
    std::memset(out + (size_t)y * ostride, 0, w * sizeof(OutT));
  if (msbs == 0 || n_passes == 0) return 0;
  uint64_t sig[64], nbr[64], sgn[64], validr[64], plane_bits[64];
  int32_t val[64 * 64];
  uint8_t lastp[64 * 64];
  std::memset(sig, 0, sizeof(sig));
  std::memset(sgn, 0, sizeof(sgn));
  std::memset(val, 0, sizeof(val));
  std::memset(lastp, 0, sizeof(lastp));
  const uint64_t colmask = w >= 64 ? ~0ull : ((1ull << w) - 1);
  for (int y = 0; y < 64; y++) validr[y] = y < h ? colmask : 0;
  BitReader rd(data, len);
  int pass_idx = 0;

  auto absorb = [&](uint64_t ones_bits, uint64_t mem, int y, int p) {
    // deposit decoded member bits; returns mask of 1s
    uint64_t ones = pdep64(ones_bits, mem);
    uint64_t mm = mem;
    while (mm) {
      int x = __builtin_ctzll(mm); mm &= mm - 1;
      int i = y * 64 + x;
      if ((ones >> x) & 1) val[i] |= 1 << p;
      lastp[i] = (uint8_t)p;
    }
    return ones;
  };

  for (int p = msbs - 1; p >= 0 && pass_idx < n_passes; p--) {
    for (int y = 0; y < h; y++) {
      uint64_t up = y > 0 ? sig[y - 1] : 0;
      uint64_t dn = y + 1 < h ? sig[y + 1] : 0;
      uint64_t t = up | sig[y] | dn;
      nbr[y] = ((t << 1) | (t >> 1) | up | dn) & colmask;
    }
    std::memset(plane_bits, 0, sizeof(plane_bits));

    // ---- SPP
    {
      uint64_t ones_row[64];
      for (int y = 0; y < h; y++) {
        uint64_t mem = ~sig[y] & nbr[y] & validr[y];
        int k = __builtin_popcountll(mem);
        ones_row[y] = absorb(rd.get(k), mem, y, p);
        plane_bits[y] |= ones_row[y];
      }
      for (int y = 0; y < h; y++) {
        uint64_t ones = ones_row[y];
        int k = __builtin_popcountll(ones);
        sgn[y] |= pdep64(rd.get(k), ones);
      }
      rd.align();
      pass_idx++;
    }
    if (pass_idx >= n_passes) break;

    // ---- MRP
    for (int y = 0; y < h; y++) {
      uint64_t mem = sig[y] & validr[y];
      int k = __builtin_popcountll(mem);
      uint64_t ones = pdep64(rd.get(k), mem);
      uint64_t mm = mem;
      while (mm) {
        int x = __builtin_ctzll(mm); mm &= mm - 1;
        int i = y * 64 + x;
        if ((ones >> x) & 1) val[i] |= 1 << p;
        lastp[i] = (uint8_t)p;
      }
    }
    rd.align();
    pass_idx++;
    if (pass_idx >= n_passes) break;

    // ---- CP
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = h - y0 < 4 ? h - y0 : 4;
      uint64_t any_mem = 0;
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        any_mem |= ~sig[y] & ~nbr[y] & validr[y];
      }
      if (!any_mem) continue;
      if (!rd.get(1)) {
        // all members zero at this plane; they still learned bit p
        for (int r = 0; r < rows; r++) {
          int y = y0 + r;
          uint64_t mm = ~sig[y] & ~nbr[y] & validr[y];
          while (mm) {
            int x = __builtin_ctzll(mm); mm &= mm - 1;
            lastp[y * 64 + x] = (uint8_t)p;
          }
        }
        continue;
      }
      uint64_t ones_row[4] = {0, 0, 0, 0};
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        uint64_t mem = ~sig[y] & ~nbr[y] & validr[y];
        int k = __builtin_popcountll(mem);
        ones_row[r] = absorb(rd.get(k), mem, y, p);
        plane_bits[y] |= ones_row[r];
      }
      for (int r = 0; r < rows; r++) {
        int y = y0 + r;
        uint64_t ones = ones_row[r];
        int k = __builtin_popcountll(ones);
        sgn[y] |= pdep64(rd.get(k), ones);
      }
    }
    rd.align();
    pass_idx++;

    for (int y = 0; y < h; y++) sig[y] |= plane_bits[y];
  }

  for (int y = 0; y < h; y++) {
    OutT* orow = out + (size_t)y * ostride;
    for (int x = 0; x < w; x++) {
      int i = y * 64 + x;
      if (!val[i]) continue;
      int u = lastp[i];
      int32_t rec = val[i] + (u > 0 ? 1 << (u - 1) : 0);
      orow[x] = (OutT)(((sgn[y] >> x) & 1) ? -rec : rec);
    }
  }
  return 0;
}

} // namespace bp

} // namespace

extern "C" {

// ------------------------------------------------- legacy int64 single APIs

int qsvc_encode_block_t(const int64_t* coeffs, int h, int w, int band,
                        uint8_t* out_buf, int out_cap,
                        int* msbs_out, int* n_passes_out,
                        int* pass_ends, double* pass_dist, double* dist0,
                        double min_slope) {
  return encode_block_impl<int64_t>(coeffs, w, h, w, band, out_buf, out_cap,
                                    msbs_out, n_passes_out, pass_ends,
                                    pass_dist, dist0, min_slope);
}

int qsvc_encode_block(const int64_t* coeffs, int h, int w, int band,
                      uint8_t* out_buf, int out_cap,
                      int* msbs_out, int* n_passes_out,
                      int* pass_ends, double* pass_dist, double* dist0) {
  return qsvc_encode_block_t(coeffs, h, w, band, out_buf, out_cap,
                             msbs_out, n_passes_out, pass_ends, pass_dist,
                             dist0, 0.0);
}

int qsvc_decode_block(const uint8_t* data, int len, int msbs, int n_passes,
                      const int* pass_ends, int n_pass_ends,
                      int h, int w, int band, int64_t* out) {
  return decode_block_impl<int64_t>(data, len, msbs, n_passes, pass_ends,
                                    n_pass_ends, h, w, band, out, w);
}

// --------------------------------------------------- legacy batched (int64)

void qsvc_encode_blocks(const int64_t* coeffs, const int* offsets,
                        const int* hs, const int* ws, const int* bands,
                        int n_blocks,
                        uint8_t* out_bufs, int out_stride,
                        int* out_lens, int* msbs, int* n_passes,
                        int* pass_ends, int pass_stride,
                        double* pass_dist, double* dist0,
                        const double* min_slopes) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n_blocks; i++) {
    out_lens[i] = qsvc_encode_block_t(
        coeffs + offsets[i], hs[i], ws[i], bands[i],
        out_bufs + (size_t)i * out_stride, out_stride,
        msbs + i, n_passes + i,
        pass_ends + (size_t)i * pass_stride,
        pass_dist + (size_t)i * pass_stride, dist0 + i,
        min_slopes ? min_slopes[i] : 0.0);
  }
}

void qsvc_decode_blocks(const uint8_t* data, const int64_t* data_offsets,
                        const int* lens, const int* msbs,
                        const int* n_passes, const int* pass_ends,
                        const int* n_pass_ends, int pass_stride,
                        const int* hs, const int* ws, const int* bands,
                        int n_blocks, int64_t* out, const int* out_offsets) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n_blocks; i++) {
    qsvc_decode_block(data + data_offsets[i], lens[i], msbs[i], n_passes[i],
                      pass_ends + (size_t)i * pass_stride, n_pass_ends[i],
                      hs[i], ws[i], bands[i], out + out_offsets[i]);
  }
}

// ------------------------------------------- strided packed-plane batched
//
// The production path: one call per (frames, H, W) stack of packed DWT
// planes (int16 or int32, as produced on device), per-block byte offsets
// into the base pointer and a shared row stride — zero host-side copies.

#define QSVC_STRIDED_ENC(NAME, T)                                            \
void NAME(const T* base, const int64_t* offsets, int stride,                 \
          const int* hs, const int* ws, const int* bands, int n_blocks,      \
          uint8_t* out_bufs, int out_stride, int* out_lens, int* msbs,       \
          int* n_passes, int* pass_ends, int pass_stride,                    \
          double* pass_dist, double* dist0, const double* min_slopes) {      \
  _Pragma("omp parallel for schedule(dynamic)")                              \
  for (int i = 0; i < n_blocks; i++) {                                       \
    out_lens[i] = encode_block_impl<T>(                                      \
        base + offsets[i], stride, hs[i], ws[i], bands[i],                   \
        out_bufs + (size_t)i * out_stride, out_stride,                       \
        msbs + i, n_passes + i,                                              \
        pass_ends + (size_t)i * pass_stride,                                 \
        pass_dist + (size_t)i * pass_stride, dist0 + i,                      \
        min_slopes ? min_slopes[i] : 0.0);                                   \
  }                                                                          \
}

QSVC_STRIDED_ENC(qsvc_encode_blocks_s16, int16_t)
QSVC_STRIDED_ENC(qsvc_encode_blocks_s32, int32_t)

// ------------------------------------------------- BP coder batch APIs

#define QSVC_BP_ENC(NAME, T)                                                 \
void NAME(const T* base, const int64_t* offsets, int stride,                 \
          const int* hs, const int* ws, const int* bands, int n_blocks,      \
          uint8_t* out_bufs, int out_stride, int* out_lens, int* msbs,       \
          int* n_passes, int* pass_ends, int pass_stride,                    \
          double* pass_dist, double* dist0, const double* min_slopes) {      \
  (void)bands;                                                               \
  _Pragma("omp parallel for schedule(dynamic)")                              \
  for (int i = 0; i < n_blocks; i++) {                                       \
    out_lens[i] = bp::encode_block<T>(                                       \
        base + offsets[i], stride, hs[i], ws[i],                             \
        out_bufs + (size_t)i * out_stride, out_stride,                       \
        msbs + i, n_passes + i,                                              \
        pass_ends + (size_t)i * pass_stride,                                 \
        pass_dist + (size_t)i * pass_stride, dist0 + i,                      \
        min_slopes ? min_slopes[i] : 0.0);                                   \
  }                                                                          \
}

QSVC_BP_ENC(qsvc_bp_encode_blocks_s16, int16_t)
QSVC_BP_ENC(qsvc_bp_encode_blocks_s32, int32_t)
QSVC_BP_ENC(qsvc_bp_encode_blocks_i64, int64_t)

void qsvc_bp_decode_blocks_s32(const uint8_t* data,
                               const int64_t* data_offsets,
                               const int* lens, const int* msbs,
                               const int* n_passes, const int* pass_ends,
                               const int* n_pass_ends, int pass_stride,
                               const int* hs, const int* ws,
                               const int* bands, int n_blocks,
                               int32_t* out_base, const int64_t* out_offsets,
                               int out_row_stride) {
  (void)pass_ends; (void)n_pass_ends; (void)pass_stride; (void)bands;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n_blocks; i++) {
    bp::decode_block<int32_t>(data + data_offsets[i], lens[i], msbs[i],
                              n_passes[i], hs[i], ws[i],
                              out_base + out_offsets[i], out_row_stride);
  }
}

void qsvc_bp_decode_blocks_i64(const uint8_t* data,
                               const int64_t* data_offsets,
                               const int* lens, const int* msbs,
                               const int* n_passes, const int* pass_ends,
                               const int* n_pass_ends, int pass_stride,
                               const int* hs, const int* ws,
                               const int* bands, int n_blocks,
                               int64_t* out, const int* out_offsets) {
  (void)pass_ends; (void)n_pass_ends; (void)pass_stride; (void)bands;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n_blocks; i++) {
    bp::decode_block<int64_t>(data + data_offsets[i], lens[i], msbs[i],
                              n_passes[i], hs[i], ws[i],
                              out + out_offsets[i], ws[i]);
  }
}

// Strided batch decode into a preallocated int32 plane stack.
void qsvc_decode_blocks_s32(const uint8_t* data, const int64_t* data_offsets,
                            const int* lens, const int* msbs,
                            const int* n_passes, const int* pass_ends,
                            const int* n_pass_ends, int pass_stride,
                            const int* hs, const int* ws, const int* bands,
                            int n_blocks, int32_t* out_base,
                            const int64_t* out_offsets, int out_row_stride) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n_blocks; i++) {
    decode_block_impl<int32_t>(
        data + data_offsets[i], lens[i], msbs[i], n_passes[i],
        pass_ends + (size_t)i * pass_stride, n_pass_ends[i],
        hs[i], ws[i], bands[i],
        out_base + out_offsets[i], out_row_stride);
  }
}

} // extern "C"
