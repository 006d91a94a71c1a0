// Baseline JPEG decoder with no library: the port's counterpart of
// ``np.asarray(PIL.Image.open(path))``.
//
// Scope: 8-bit baseline (SOF0) and extended sequential (SOF1) Huffman
// files with one or three components, sampled 4:4:4, 4:2:2 (h2v1) or 4:2:0
// (h2v2), interleaved or not, with or without restart intervals, with the
// standard or optimised Huffman tables, of any width and height. That is
// what nuScenes' cameras and Pillow's ``save`` write. Progressive,
// arithmetic-coded, lossless, hierarchical, 12-bit and four-component
// (CMYK / YCCK) files, RGB-coded files and other sampling ratios return
// FFJ_UNSUPPORTED.
//
// The target is the output of libjpeg-turbo as Pillow drives it (its
// defaults: JDCT_ISLOW, fancy upsampling, YCbCr -> RGB), bit for bit:
// - the IDCT is jidctint.c's jpeg_idct_islow (13-bit constants,
//   PASS1_BITS 2, the output through the range-limit table masked with
//   1023); quantisation values are ISLOW_MULT_TYPE, a short;
// - chroma is upsampled as jdsample.c does: h2v1_fancy_upsample (biases 1
//   and 2) and h2v2_fancy_upsample (the triangle filter, biases 8 and 7,
//   the rows above the first and below the last replicated as jdmainct.c's
//   context pointers do) where the downsampled width is above 2, else the
//   box replication of h2v1_upsample / h2v2_upsample;
// - colour is jdcolor.c's ycc_rgb_convert with its fixed-point tables
//   (SCALEBITS 16, ONE_HALF rounding) and the sample range limit.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int FFJ_OK = 0;
constexpr int FFJ_UNSUPPORTED = 1;
constexpr int FFJ_CORRUPT = 2;

struct JpegError {
  int status;
  std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) {
  throw JpegError{status, msg};
}

// jutils.c's jpeg_natural_order, with 16 extra entries so that a corrupt
// run length cannot index past the block (as libjpeg does)
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18] = {0};
  int32_t valoffset[18] = {0};
  int32_t lookup[1 << kLookBits] = {0};  // (length << 8) | symbol, 0: longer
};

// jdhuff.c's jpeg_make_d_derived_tbl
void build_huffman(HuffTable& t) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 1; i <= t.bits[l]; i++) {
      if (p >= 256) fail(FFJ_CORRUPT, "bad Huffman table");
      huffsize[p++] = l;
    }
  }
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) fail(FFJ_CORRUPT, "bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.lookup, 0, sizeof(t.lookup));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int look = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int c = 1 << (kLookBits - l); c > 0; c--) {
        t.lookup[look++] = (l << 8) | t.vals[p];
      }
    }
  }
  t.defined = true;
}

// The entropy-coded segment's bits, with 0xFF00 unstuffed. At a marker it
// stops (keeping the marker for the parser) and feeds zeros, as libjpeg's
// fill_bit_buffer does.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  int marker = 0;  // a marker met inside the segment, 0 if none

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      if (marker == 0 && p < end) {
        c = *p++;
        if (c == 0xFF) {
          uint32_t d = 0;
          do {
            d = p < end ? *p++ : 0xD9;  // a file cut short ends like EOI
          } while (d == 0xFF);
          if (d != 0) {
            marker = static_cast<int>(d);
            c = 0;
          }
        }
      }
      buf = (buf << 8) | c;
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (nbits - n)) & ((1u << n) - 1);
  }
  inline void skip(int n) { nbits -= n; }
  inline uint32_t get(int n) {
    uint32_t v = peek(n);
    nbits -= n;
    return v;
  }
  // jdhuff.c's process_restart: drop the bits left, then the next marker
  // must be RSTn
  void restart(int expected) {
    buf = 0;
    nbits = 0;
    if (marker == 0) {
      while (p < end) {
        if (*p++ != 0xFF) continue;
        while (p < end && *p == 0xFF) p++;
        if (p < end && *p != 0) {
          marker = *p++;
          break;
        }
      }
    }
    if (marker != 0xD0 + expected) {
      fail(FFJ_CORRUPT, "restart marker missing or out of order");
    }
    marker = 0;
  }
};

inline int decode_huffman(BitReader& br, const HuffTable& t) {
  int v = t.lookup[br.peek(kLookBits)];
  if (v) {
    br.skip(v >> 8);
    return v & 0xFF;
  }
  int l = kLookBits + 1;
  int32_t code = static_cast<int32_t>(br.get(l));
  while (code > t.maxcode[l]) {
    code = (code << 1) | static_cast<int32_t>(br.get(1));
    l++;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg warns and takes 0
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int r, int s) {
  return r + (((r - (1 << (s - 1))) >> 31) & (static_cast<int>(~0u << s) + 1));
}

void decode_block(BitReader& br, const HuffTable& dc, const HuffTable& ac,
                  int& pred, int16_t* blk) {
  std::memset(blk, 0, 64 * sizeof(int16_t));
  int s = decode_huffman(br, dc);
  if (s) s = extend(static_cast<int>(br.get(s)), s);
  pred += s;
  blk[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64; k++) {
    int rs = decode_huffman(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend(static_cast<int>(br.get(s)), s);
      blk[kNatural[k]] = static_cast<int16_t>(v);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// jidctint.c, jpeg_idct_islow
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

struct Idct {
  uint8_t range[1024];
  Idct() {
    // jdmaster.c's prepare_range_limit_table, seen from the IDCT
    // (sample_range_limit + CENTERJSAMPLE, masked with RANGE_MASK 1023)
    for (int x = 0; x < 1024; x++) {
      range[x] = static_cast<uint8_t>(x < 128 ? x + 128
                                      : x < 512 ? 255
                                      : x < 896 ? 0
                                                : x - 896);
    }
  }

  void run(const int16_t* coef, const int16_t* q, uint8_t* out,
           int stride) const {
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* in = coef + c;
      const int16_t* qt = q + c;
      int* w = ws + c;
      if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
          in[40] == 0 && in[48] == 0 && in[56] == 0) {
        int dc = (int(in[0]) * int(qt[0])) * (1 << PASS1_BITS);
        for (int r = 0; r < 8; r++) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = int64_t(in[16]) * qt[16];
      int64_t z3 = int64_t(in[48]) * qt[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = int64_t(in[0]) * qt[0];
      z3 = int64_t(in[32]) * qt[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(in[56]) * qt[56];
      tmp1 = int64_t(in[40]) * qt[40];
      tmp2 = int64_t(in[24]) * qt[24];
      tmp3 = int64_t(in[8]) * qt[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int s = CONST_BITS - PASS1_BITS;
      w[0] = int(descale(tmp10 + tmp3, s));
      w[56] = int(descale(tmp10 - tmp3, s));
      w[8] = int(descale(tmp11 + tmp2, s));
      w[48] = int(descale(tmp11 - tmp2, s));
      w[16] = int(descale(tmp12 + tmp1, s));
      w[40] = int(descale(tmp12 - tmp1, s));
      w[24] = int(descale(tmp13 + tmp0, s));
      w[32] = int(descale(tmp13 - tmp0, s));
    }
    constexpr int s2 = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + r * stride;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
          w[6] == 0 && w[7] == 0) {
        uint8_t v = range[int(descale(w[0], PASS1_BITS + 3)) & 1023];
        for (int c = 0; c < 8; c++) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp0 *= FIX_0_298631336;
      tmp1 *= FIX_2_053119869;
      tmp2 *= FIX_3_072711026;
      tmp3 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = range[int(descale(tmp10 + tmp3, s2)) & 1023];
      o[7] = range[int(descale(tmp10 - tmp3, s2)) & 1023];
      o[1] = range[int(descale(tmp11 + tmp2, s2)) & 1023];
      o[6] = range[int(descale(tmp11 - tmp2, s2)) & 1023];
      o[2] = range[int(descale(tmp12 + tmp1, s2)) & 1023];
      o[5] = range[int(descale(tmp12 - tmp1, s2)) & 1023];
      o[3] = range[int(descale(tmp13 + tmp0, s2)) & 1023];
      o[4] = range[int(descale(tmp13 - tmp0, s2)) & 1023];
    }
  }
};

const Idct kIdct;

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SCALEBITS) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
  }
};

const YccTables kYcc;

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;    // Huffman tables of the current scan
  int pred = 0;          // DC predictor
  int bw = 0, bh = 0;    // blocks per row / column of the padded plane
  int dw = 0, dh = 0;    // downsampled width / height (jdmaster.c)
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int pending_marker = 0;
  int16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[3];

  Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n), p(d) {}

  int u8() {
    if (p >= end) fail(FFJ_CORRUPT, "unexpected end of file");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    if (pending_marker) {
      int m = pending_marker;
      pending_marker = 0;
      return m;
    }
    // skip anything up to 0xFF, then fill bytes (jdmarker.c's next_marker)
    while (true) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_dqt(int len) {
    const uint8_t* stop = p + len - 2;
    while (p < stop) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail(FFJ_CORRUPT, "bad quantisation table id");
      for (int i = 0; i < 64; i++) {
        int v = pq ? u16() : u8();
        // ISLOW_MULT_TYPE is a short for 8-bit samples (jddctmgr.c)
        qt[tq][kNatural[i]] = static_cast<int16_t>(v);
      }
      qt_defined[tq] = true;
    }
    p = stop;
  }

  void read_dht(int len) {
    const uint8_t* stop = p + len - 2;
    while (p < stop) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(FFJ_CORRUPT, "bad Huffman table id");
      HuffTable& t = tc ? ac[th] : dc[th];
      t.bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        t.bits[l] = static_cast<uint8_t>(u8());
        count += t.bits[l];
      }
      if (count > 256) fail(FFJ_CORRUPT, "bad Huffman table");
      std::memset(t.vals, 0, sizeof(t.vals));
      for (int i = 0; i < count; i++) t.vals[i] = static_cast<uint8_t>(u8());
      build_huffman(t);
    }
    p = stop;
  }

  void read_sof(int len) {
    if (frame) fail(FFJ_CORRUPT, "two frames");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) {
      fail(FFJ_UNSUPPORTED, std::to_string(precision) + "-bit samples");
    }
    if (ncomp == 4) fail(FFJ_UNSUPPORTED, "four components (CMYK / YCCK)");
    if (ncomp != 1 && ncomp != 3) {
      fail(FFJ_UNSUPPORTED, std::to_string(ncomp) + " components");
    }
    if (width <= 0 || height <= 0) fail(FFJ_CORRUPT, "empty image");
    if (len != 8 + 3 * ncomp) fail(FFJ_CORRUPT, "bad SOF length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        fail(FFJ_CORRUPT, "bad component sampling");
      }
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      int rh = hmax / c.h, rv = vmax / c.v;
      if (ncomp == 3 && !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                          (rh == 2 && rv == 2))) {
        fail(FFJ_UNSUPPORTED, "sampling other than 4:4:4, 4:2:2, 4:2:0");
      }
      if (hmax % c.h || vmax % c.v) {
        fail(FFJ_UNSUPPORTED, "non-integral sampling ratio");
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  void read_app14(int len) {
    const uint8_t* stop = p + len - 2;
    if (len >= 14 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    p = stop;
  }

  void read_app0(int len) {
    const uint8_t* stop = p + len - 2;
    if (len >= 7 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    p = stop;
  }

  void check_color_space() {
    if (ncomp != 3) return;
    // jdapimin.c's default_decompress_parms for three components
    if (jfif) return;
    if (adobe) {
      if (adobe_transform == 0) fail(FFJ_UNSUPPORTED, "RGB-coded (Adobe)");
      return;
    }
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') {
      fail(FFJ_UNSUPPORTED, "RGB-coded (component ids R, G, B)");
    }
  }

  void read_sos(int len) {
    if (!frame) fail(FFJ_CORRUPT, "scan before frame");
    for (int i = 0; i < ncomp; i++) {  // the planes, at the first scan
      Component& c = comp[i];
      if (c.plane.empty()) c.plane.assign(size_t(c.bw) * 64 * c.bh, 0);
    }
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) {
      fail(FFJ_CORRUPT, "bad scan header");
    }
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (!c) fail(FFJ_CORRUPT, "scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined) {
        fail(FFJ_CORRUPT, "scan uses an undefined Huffman table");
      }
      if (!qt_defined[c->tq]) {
        fail(FFJ_CORRUPT, "undefined quantisation table");
      }
      c->pred = 0;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) {
      fail(FFJ_CORRUPT, "bad spectral selection for a sequential scan");
    }
    BitReader br{p, end};
    int16_t blk[64];
    int restarts = 0, left = restart_interval;
    auto maybe_restart = [&]() {
      if (restart_interval == 0) return;
      if (left == 0) {
        br.restart(restarts);
        restarts = (restarts + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
        left = restart_interval;
      }
      left--;
    };
    if (ns == 1) {
      // non-interleaved: blocks in raster order over the component's own
      // (unpadded to the MCU) extent
      Component& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      int stride = c.bw * 8;
      for (int by = 0; by < nby; by++) {
        for (int bx = 0; bx < nbx; bx++) {
          maybe_restart();
          decode_block(br, dc[c.td], ac[c.ta], c.pred, blk);
          kIdct.run(blk, qt[c.tq],
                    c.plane.data() + size_t(by) * 8 * stride + bx * 8,
                    stride);
        }
      }
    } else {
      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          maybe_restart();
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            int stride = c.bw * 8;
            for (int v = 0; v < c.v; v++) {
              for (int h = 0; h < c.h; h++) {
                decode_block(br, dc[c.td], ac[c.ta], c.pred, blk);
                size_t row = size_t(my * c.v + v) * 8;
                size_t col = size_t(mx * c.h + h) * 8;
                kIdct.run(blk, qt[c.tq], c.plane.data() + row * stride + col,
                          stride);
              }
            }
          }
        }
      }
    }
    p = br.p;
    pending_marker = br.marker;
  }

  // Reads the segments up to EOI, decoding each scan; with header_only it
  // stops after the frame header (SOF).
  void parse(bool header_only) {
    if (u8() != 0xFF || u8() != 0xD8) fail(FFJ_CORRUPT, "not a JPEG file");
    bool scanned = false;
    while (true) {
      int m = next_marker();
      if (m == 0xD9) break;                             // EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM
      int len = u16();
      if (len < 2 || p + len - 2 > end) fail(FFJ_CORRUPT, "bad segment");
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(len);
          check_color_space();
          if (header_only) return;
          break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE:
          fail(FFJ_UNSUPPORTED, "progressive JPEG");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          fail(FFJ_UNSUPPORTED, "lossless JPEG");
        case 0xC5:
          fail(FFJ_UNSUPPORTED, "hierarchical JPEG");
        case 0xC9: case 0xCD: case 0xCC:
          fail(FFJ_UNSUPPORTED, "arithmetic-coded JPEG");
        case 0xC4:
          read_dht(len);
          break;
        case 0xDB:
          read_dqt(len);
          break;
        case 0xDD:
          if (len != 4) fail(FFJ_CORRUPT, "bad DRI");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos(len);
          scanned = true;
          break;
        case 0xE0:
          read_app0(len);
          break;
        case 0xEE:
          read_app14(len);
          break;
        default:
          p += len - 2;  // APPn, COM, DNL, ...
      }
      if (p >= end && scanned) break;  // no EOI: keep what was decoded
    }
    if (!frame) fail(FFJ_CORRUPT, "no frame header");
    if (!scanned) fail(FFJ_CORRUPT, "no scan");
  }

  // row y of a component at the full resolution (>= width samples)
  void upsample_row(const Component& c, int y, int* colsum,
                    uint8_t* out) const {
    const int stride = c.bw * 8;
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int dw = c.dw;
    const bool fancy = dw > 2;  // jdsample.c: fancy only above 2 columns
    if (rh == 1) {
      std::memcpy(out, c.plane.data() + size_t(y) * stride, width);
      return;
    }
    if (rv == 1) {  // h2v1
      const uint8_t* in = c.plane.data() + size_t(y) * stride;
      if (!fancy) {
        for (int x = 0; x < dw; x++) out[2 * x] = out[2 * x + 1] = in[x];
        return;
      }
      int v0 = in[0];
      out[0] = static_cast<uint8_t>(v0);
      out[1] = static_cast<uint8_t>((v0 * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = in[x] * 3;
        out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      int vl = in[dw - 1];
      out[2 * dw - 2] = static_cast<uint8_t>((vl * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = static_cast<uint8_t>(vl);
      return;
    }
    // h2v2
    const int inrow = y / 2;
    if (!fancy) {
      const uint8_t* in = c.plane.data() + size_t(inrow) * stride;
      for (int x = 0; x < dw; x++) out[2 * x] = out[2 * x + 1] = in[x];
      return;
    }
    int other = (y & 1) ? inrow + 1 : inrow - 1;
    other = std::min(std::max(other, 0), c.dh - 1);
    const uint8_t* in0 = c.plane.data() + size_t(inrow) * stride;
    const uint8_t* in1 = c.plane.data() + size_t(other) * stride;
    for (int x = 0; x < dw; x++) colsum[x] = in0[x] * 3 + in1[x];
    int t = colsum[0];
    out[0] = static_cast<uint8_t>((t * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((t * 3 + colsum[1] + 7) >> 4);
    for (int x = 1; x < dw - 1; x++) {
      t = colsum[x] * 3;
      out[2 * x] = static_cast<uint8_t>((t + colsum[x - 1] + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((t + colsum[x + 1] + 7) >> 4);
    }
    t = colsum[dw - 1];
    out[2 * dw - 2] = static_cast<uint8_t>((t * 3 + colsum[dw - 2] + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((t * 4 + 7) >> 4);
  }

  void emit(uint8_t* out) const {
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; y++) {
        std::memcpy(out + size_t(y) * width,
                    c.plane.data() + size_t(y) * c.bw * 8, width);
      }
      return;
    }
    const int wpad = width + 16;
    std::vector<uint8_t> rows(3 * size_t(wpad));
    std::vector<int> colsum(wpad);
    uint8_t* yr = rows.data();
    uint8_t* cb = yr + wpad;
    uint8_t* cr = cb + wpad;
    for (int y = 0; y < height; y++) {
      upsample_row(comp[0], y, colsum.data(), yr);
      upsample_row(comp[1], y, colsum.data(), cb);
      upsample_row(comp[2], y, colsum.data(), cr);
      uint8_t* o = out + size_t(y) * width * 3;
      for (int x = 0; x < width; x++) {
        int Y = yr[x], Cb = cb[x], Cr = cr[x];
        o[3 * x] = clamp8(Y + kYcc.cr_r[Cr]);
        o[3 * x + 1] = clamp8(
            Y + static_cast<int>((kYcc.cb_g[Cb] + kYcc.cr_g[Cr]) >> 16));
        o[3 * x + 2] = clamp8(Y + kYcc.cb_b[Cb]);
      }
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Width, height and components (1: grayscale, 3: colour) of a JPEG in
// memory; 0, or FFJ_UNSUPPORTED / FFJ_CORRUPT with a message in ``err``.
int ffj_jpeg_info(const uint8_t* data, int64_t n, int32_t* width,
                  int32_t* height, int32_t* comps, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(true);
    *width = d.width;
    *height = d.height;
    *comps = d.ncomp;
    return FFJ_OK;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return e.status;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return FFJ_CORRUPT;
  }
}

// Decode into ``out``: height x width x comps bytes (RGB or gray).
int ffj_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int64_t out_size, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(false);
    if (int64_t(d.width) * d.height * d.ncomp != out_size) {
      fail(FFJ_CORRUPT, "output buffer of the wrong size");
    }
    d.emit(out);
    return FFJ_OK;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return e.status;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return FFJ_CORRUPT;
  }
}

}  // extern "C"
