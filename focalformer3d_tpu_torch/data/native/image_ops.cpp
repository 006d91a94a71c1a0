// Pillow's geometry on interleaved uint8 images (H x W x C, C >= 1), bit
// for bit: the port's counterparts of ``Image.resize`` with its default
// filter and of the nearest-neighbour affine that ``Image.rotate`` ends in.
//
// Resize is libImaging/Resample.c: ``precompute_coeffs`` with the bicubic
// filter (a = -0.5, support 2, widened by the scale when downscaling),
// coefficients normalised per output pixel in double, then rounded to
// fixed point with PRECISION_BITS = 22 (``normalize_coeffs_8bpc``); a
// horizontal pass over the rows the vertical pass reads, then a vertical
// pass, each accumulating in int32 from 1 << 21 and clipping ``>> 22`` to
// [0, 255]. A pass whose size does not change is skipped, as Pillow does.
//
// The affine is libImaging/Geometry.c's ``ImagingTransformAffine`` for
// NEAREST: ``ImagingScaleAffine`` where the matrix has no shear, else the
// 16.16 fixed-point ``affine_fixed``, which Pillow takes where every corner
// maps within +-32768 (beyond, its floating-point loop is not ported);
// pixels that map outside the input are 0 (the fill of ``Image.transform``).
//
// Build with -ffp-contract=off: Pillow's double arithmetic has no fused
// multiply-adds, and one would move a coefficient by an ulp.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

inline uint8_t clip8(int32_t in) {
  int32_t v = in >> PRECISION_BITS;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Resample.c's precompute_coeffs + normalize_coeffs_8bpc
int precompute(int in_size, float in0, float in1, int out_size,
               std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(size_t(out_size) * ksize, 0.0);
  bounds.assign(size_t(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[size_t(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    bounds[size_t(xx) * 2] = xmin;
    bounds[size_t(xx) * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); i++) {
    kk[i] = pre[i] < 0
                ? static_cast<int32_t>(-0.5 + pre[i] * (1 << PRECISION_BITS))
                : static_cast<int32_t>(0.5 + pre[i] * (1 << PRECISION_BITS));
  }
  return ksize;
}

}  // namespace

extern "C" {

// Image.resize((out_w, out_h)) with the default BICUBIC filter and box
// (0, 0, in_w, in_h).
void ffi_resize_bicubic(const uint8_t* in, int in_h, int in_w, int channels,
                        uint8_t* out, int out_h, int out_w) {
  const int C = channels;
  if (in_h == out_h && in_w == out_w) {
    std::memcpy(out, in, size_t(in_h) * in_w * C);
    return;
  }
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  int ksh = precompute(in_w, 0.0f, static_cast<float>(in_w), out_w, bh, kh);
  int ksv = precompute(in_h, 0.0f, static_cast<float>(in_h), out_h, bv, kv);
  const bool need_h = out_w != in_w;
  const bool need_v = out_h != in_h;
  const uint8_t* src = in;
  int src_w = in_w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    int first = bv[0];
    int last = bv[size_t(out_h) * 2 - 2] + bv[size_t(out_h) * 2 - 1];
    if (need_v) {
      for (int i = 0; i < out_h; i++) bv[size_t(i) * 2] -= first;
    } else {
      first = 0;
      last = in_h;
    }
    int rows = last - first;
    uint8_t* dst = need_v ? nullptr : out;
    if (need_v) {
      tmp.resize(size_t(rows) * out_w * C);
      dst = tmp.data();
    }
    for (int y = 0; y < rows; y++) {
      const uint8_t* row = in + size_t(y + first) * in_w * C;
      uint8_t* o = dst + size_t(y) * out_w * C;
      for (int xx = 0; xx < out_w; xx++) {
        const int xmin = bh[size_t(xx) * 2], xmax = bh[size_t(xx) * 2 + 1];
        const int32_t* k = &kh[size_t(xx) * ksh];
        const uint8_t* p = row + size_t(xmin) * C;
        if (C == 3) {  // Pillow's own loop for three bands
          int32_t s0 = 1 << (PRECISION_BITS - 1), s1 = s0, s2 = s0;
          for (int x = 0; x < xmax; x++, p += 3) {
            s0 += int32_t(p[0]) * k[x];
            s1 += int32_t(p[1]) * k[x];
            s2 += int32_t(p[2]) * k[x];
          }
          o[xx * 3] = clip8(s0);
          o[xx * 3 + 1] = clip8(s1);
          o[xx * 3 + 2] = clip8(s2);
          continue;
        }
        for (int c = 0; c < C; c++) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; x++) ss += int32_t(p[x * C + c]) * k[x];
          o[xx * C + c] = clip8(ss);
        }
      }
    }
    if (!need_v) return;
    src = tmp.data();
    src_w = out_w;
  }
  // row by row: each sample still sums its taps in Pillow's order (y up),
  // in int32, so the result is Pillow's; the rows stream through the cache
  const size_t n = size_t(src_w) * C;
  std::vector<int32_t> acc(n);
  for (int yy = 0; yy < out_h; yy++) {
    const int ymin = bv[size_t(yy) * 2], ymax = bv[size_t(yy) * 2 + 1];
    const int32_t* k = &kv[size_t(yy) * ksv];
    std::fill(acc.begin(), acc.end(), 1 << (PRECISION_BITS - 1));
    for (int y = 0; y < ymax; y++) {
      const uint8_t* row = src + size_t(y + ymin) * n;
      const int32_t ky = k[y];
      for (size_t i = 0; i < n; i++) acc[i] += int32_t(row[i]) * ky;
    }
    uint8_t* o = out + size_t(yy) * n;
    for (size_t i = 0; i < n; i++) o[i] = clip8(acc[i]);
  }
}

// Image.transform(size, AFFINE, a, NEAREST) into a zeroed out_h x out_w
// image (libImaging/Geometry.c: ImagingTransformAffine). Returns 1, and
// writes nothing but zeros, where a corner maps beyond +-32768 (Pillow's
// floating-point path, which no camera image reaches).
int ffi_affine_nearest(const uint8_t* in, int in_h, int in_w, int channels,
                        uint8_t* out, int out_h, int out_w,
                        const double* a) {
  const int C = channels;
  std::memset(out, 0, size_t(out_h) * out_w * C);
  auto coord = [](double v) { return v < 0.0 ? -1 : static_cast<int>(v); };
  auto put = [&](int y, int x, int yin, int xin) {
    std::memcpy(out + (size_t(y) * out_w + x) * C,
                in + (size_t(yin) * in_w + xin) * C, C);
  };
  if (a[1] == 0 && a[3] == 0) {  // ImagingScaleAffine
    std::vector<int> xintab(out_w, 0);
    double xo = a[2] + a[0] * 0.5;
    double yo = a[5] + a[4] * 0.5;
    int xmin = out_w, xmax = 0;
    for (int x = 0; x < out_w; x++) {
      int xin = coord(xo);
      if (xin >= 0 && xin < in_w) {
        xmax = x + 1;
        if (x < xmin) xmin = x;
        xintab[x] = xin;
      }
      xo += a[0];
    }
    for (int y = 0; y < out_h; y++) {
      int yi = coord(yo);
      if (yi >= 0 && yi < in_h) {
        for (int x = xmin; x < xmax; x++) put(y, x, yi, xintab[x]);
      }
      yo += a[4];
    }
    return 0;
  }
  auto check_fixed = [&](int x, int y) {
    return std::fabs(x * a[0] + y * a[1] + a[2]) < 32768.0 &&
           std::fabs(x * a[3] + y * a[4] + a[5]) < 32768.0;
  };
  if (!(check_fixed(0, 0) && check_fixed(out_w, out_h) &&
        check_fixed(0, out_h) && check_fixed(out_w, 0))) {
    return 1;  // Pillow's floating-point loop: not ported
  }
  // affine_fixed: 16.16 fixed point
  auto fix = [](double v) {
    double t = v * 65536.0 + 0.5;
    return t < 0.0 ? static_cast<int32_t>(std::floor(t))
                   : static_cast<int32_t>(t);
  };
  int32_t a0 = fix(a[0]), a1 = fix(a[1]), a3 = fix(a[3]), a4 = fix(a[4]);
  int32_t a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5);
  int32_t a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5);
  for (int y = 0; y < out_h; y++) {
    int32_t xx = a2, yy = a5;
    for (int x = 0; x < out_w; x++) {
      int xin = xx >> 16;
      if (xin >= 0 && xin < in_w) {
        int yin = yy >> 16;
        if (yin >= 0 && yin < in_h) put(y, x, yin, xin);
      }
      xx += a0;
      yy += a3;
    }
    a2 += a1;
    a5 += a4;
  }
  return 0;
}

}  // extern "C"
