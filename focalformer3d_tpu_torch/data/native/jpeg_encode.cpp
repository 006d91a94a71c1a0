// Baseline JPEG writer for test fixtures and the written camera directory
// of data/synthetic_dirs.py: 8-bit YCbCr with 4:2:0 sampling (grayscale for
// one channel), JFIF header, the quantisation tables of ITU-T
// T.81 Annex K scaled by libjpeg's quality rule (jcparam.c), the Annex K
// Huffman tables, edge-replicated padding to whole MCUs. Nothing on the
// data path uses it: it lets a machine without Pillow write the JPEGs that
// the decoder reads.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K, tables K.1 and K.2 (natural order)
const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3, tables K.3-K.6 (jcparam.c's std_huff_tables)
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256];
  uint8_t size[256];
};

Code make_code(const uint8_t* bits, const uint8_t* vals) {
  Code c{};
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++) {
      c.code[vals[k]] = static_cast<uint16_t>(code);
      c.size[vals[k]] = static_cast<uint8_t>(l);
      code++;
      k++;
    }
    code <<= 1;
  }
  return c;
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nacc = 0;

  void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void bits(uint32_t v, int n) {
    while (n > 0) {
      int take = n < 8 ? n : 8;
      n -= take;
      acc = (acc << take) | ((v >> n) & ((1u << take) - 1));
      nacc += take;
      while (nacc >= 8) {
        int b = (acc >> (nacc - 8)) & 0xFF;
        byte(b);
        if (b == 0xFF) byte(0);
        nacc -= 8;
      }
    }
  }
  void flush() {
    if (nacc > 0) bits((1u << (8 - nacc)) - 1, 8 - nacc);
  }
};

// libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)
void scaled_table(const int* base, int quality, int* q) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 255L) t = 255L;
    q[i] = static_cast<int>(t);
  }
}

struct Dct {
  double c[8][8];
  Dct() {
    for (int u = 0; u < 8; u++) {
      double a = u == 0 ? std::sqrt(0.125) : 0.5;
      for (int x = 0; x < 8; x++) {
        c[u][x] = a * std::cos((2 * x + 1) * u * M_PI / 16.0);
      }
    }
  }
  // samples (level-shifted) -> quantised coefficients in natural order
  void run(const double* s, const int* q, int* coef) const {
    double tmp[64];
    for (int y = 0; y < 8; y++) {
      for (int u = 0; u < 8; u++) {
        double acc = 0;
        for (int x = 0; x < 8; x++) acc += c[u][x] * s[y * 8 + x];
        tmp[y * 8 + u] = acc;
      }
    }
    for (int u = 0; u < 8; u++) {
      for (int v = 0; v < 8; v++) {
        double acc = 0;
        for (int y = 0; y < 8; y++) acc += c[v][y] * tmp[y * 8 + u];
        long x = std::lround(acc / q[v * 8 + u]);
        // baseline's AC tables code at most 10 magnitude bits
        if (u || v) x = x < -1023 ? -1023 : x > 1023 ? 1023 : x;
        coef[v * 8 + u] = static_cast<int>(x);
      }
    }
  }
};

int magnitude(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    n++;
    a >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const int* coef, int& pred, const Code& dc,
                  const Code& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int n = magnitude(diff);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = magnitude(v);
    int sym = (run << 4) | n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) w.bits(ac.code[0], ac.size[0]);
}

void put_dht(Writer& w, int id, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + count);
  w.byte(id);
  for (int l = 1; l <= 16; l++) w.byte(bits[l]);
  for (int i = 0; i < count; i++) w.byte(vals[i]);
}

}  // namespace

extern "C" {

// Encode an h x w x channels (1 or 3) uint8 image. Writes at most
// ``capacity`` bytes into ``out`` and returns the file's length, or -1 if
// it does not fit.
int64_t ffj_jpeg_encode(const uint8_t* img, int h, int w, int channels,
                        int quality, uint8_t* out, int64_t capacity) {
  const bool gray = channels == 1;
  const int hs = gray ? 1 : 2;  // luma samples per chroma sample
  int ql[64], qc[64];
  scaled_table(kLumaQ, quality, ql);
  scaled_table(kChromaQ, quality, qc);
  // YCbCr planes (JFIF, full range), edge-replicated to whole MCUs
  const int mw = 8 * hs, mh = 8 * hs;
  const int pw = (w + mw - 1) / mw * mw, ph = (h + mh - 1) / mh * mh;
  const int ncomp = gray ? 1 : 3;
  std::vector<double> plane[3];
  for (int c = 0; c < ncomp; c++) plane[c].resize(size_t(pw) * ph);
  for (int y = 0; y < ph; y++) {
    const int sy = y < h ? y : h - 1;
    for (int x = 0; x < pw; x++) {
      const int sx = x < w ? x : w - 1;
      const uint8_t* px = img + (size_t(sy) * w + sx) * channels;
      size_t i = size_t(y) * pw + x;
      if (gray) {
        plane[0][i] = px[0];
        continue;
      }
      double r = px[0], g = px[1], b = px[2];
      plane[0][i] = 0.299 * r + 0.587 * g + 0.114 * b;
      plane[1][i] = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0;
      plane[2][i] = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0;
    }
  }
  Writer wr;
  wr.word(0xFFD8);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  wr.word(16);
  for (uint8_t b : jfif) wr.byte(b);
  for (int t = 0; t < (gray ? 1 : 2); t++) {
    const int* q = t ? qc : ql;
    wr.word(0xFFDB);
    wr.word(67);
    wr.byte(t);
    for (int k = 0; k < 64; k++) wr.byte(q[kZigzag[k]]);
  }
  wr.word(0xFFC0);
  wr.word(8 + 3 * ncomp);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(ncomp);
  for (int c = 0; c < ncomp; c++) {
    wr.byte(c + 1);
    wr.byte(c == 0 ? (hs << 4) | hs : 0x11);
    wr.byte(c == 0 ? 0 : 1);
  }
  put_dht(wr, 0x00, kDcLumaBits, kDcLumaVals);
  put_dht(wr, 0x10, kAcLumaBits, kAcLumaVals);
  if (!gray) {
    put_dht(wr, 0x01, kDcChromaBits, kDcChromaVals);
    put_dht(wr, 0x11, kAcChromaBits, kAcChromaVals);
  }
  wr.word(0xFFDA);
  wr.word(6 + 2 * ncomp);
  wr.byte(ncomp);
  for (int c = 0; c < ncomp; c++) {
    wr.byte(c + 1);
    wr.byte(c == 0 ? 0x00 : 0x11);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);
  const Code dcl = make_code(kDcLumaBits, kDcLumaVals);
  const Code acl = make_code(kAcLumaBits, kAcLumaVals);
  const Code dcc = make_code(kDcChromaBits, kDcChromaVals);
  const Code acc = make_code(kAcChromaBits, kAcChromaVals);
  const Dct dct;
  int pred[3] = {0, 0, 0};
  double s[64];
  int coef[64];
  for (int my = 0; my < ph / mh; my++) {
    for (int mx = 0; mx < pw / mw; mx++) {
      for (int by = 0; by < hs; by++) {
        for (int bx = 0; bx < hs; bx++) {
          for (int y = 0; y < 8; y++) {
            for (int x = 0; x < 8; x++) {
              size_t i = size_t(my * mh + by * 8 + y) * pw + mx * mw +
                         bx * 8 + x;
              s[y * 8 + x] = plane[0][i] - 128.0;
            }
          }
          dct.run(s, ql, coef);
          encode_block(wr, coef, pred[0], dcl, acl);
        }
      }
      for (int c = 1; c < ncomp; c++) {
        // the mean of each hs x hs group of samples
        for (int y = 0; y < 8; y++) {
          for (int x = 0; x < 8; x++) {
            double acc_v = 0;
            for (int dy = 0; dy < hs; dy++) {
              for (int dx = 0; dx < hs; dx++) {
                size_t i = size_t(my * mh + y * hs + dy) * pw + mx * mw +
                           x * hs + dx;
                acc_v += plane[c][i];
              }
            }
            s[y * 8 + x] = acc_v / (hs * hs) - 128.0;
          }
        }
        dct.run(s, qc, coef);
        encode_block(wr, coef, pred[c], dcc, acc);
      }
    }
  }
  wr.flush();
  wr.word(0xFFD9);
  if (int64_t(wr.out.size()) > capacity) return -1;
  std::memcpy(out, wr.out.data(), wr.out.size());
  return int64_t(wr.out.size());
}

}  // extern "C"
