// codec: the pixel loops of the port's image reader and writer
// (`utils/image.py`), which are too slow in Python: baseline JPEG Huffman
// decoding and encoding of quantised DCT blocks, PNG row unfiltering, and
// lens undistortion (OpenCV's undistort map and bilinear remap).
// Everything else of the codecs (markers, zlib, the IDCT, upsampling and
// colour conversion) is numpy in `utils/image.py`.
//
// Huffman tables arrive as the DHT segment gives them: for table slot
// t = class * 4 + id (class 0 DC, 1 AC), 16 code-length counts at
// bits[16 t] and the symbols at vals[256 t].

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct DecTable {
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valptr[17];    // index of the first symbol of each length
  int32_t mincode[17];
  uint8_t vals[256];
  bool present;
};

void build_dec(DecTable& t, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 0; l < 16; ++l) n += bits[l];
  t.present = n > 0;
  std::memcpy(t.vals, vals, 256);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    int cnt = bits[l - 1];
    if (cnt) {
      t.valptr[l] = k;
      t.mincode[l] = code;
      code += cnt;
      k += cnt;
      t.maxcode[l] = code - 1;
    } else {
      t.maxcode[l] = -1;
    }
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t buf = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 24) {
      uint32_t byte = 0;
      if (!hit_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          uint8_t nxt = (p + 1 < end) ? p[1] : 0xD9;
          if (nxt == 0x00) {
            p += 2;
          } else {
            hit_marker = true;  // a marker: feed zeros from here, as
            byte = 0;           // libjpeg does on a short segment
          }
        } else {
          ++p;
        }
      }
      buf |= byte << (24 - nbits);
      nbits += 8;
    }
  }
  int bit() {
    if (nbits < 1) fill();
    int b = (buf >> 31) & 1;
    buf <<= 1;
    --nbits;
    return b;
  }
  int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(buf >> (32 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }
  // skip to the next RSTn marker and past it; reset the bit buffer
  bool restart() {
    buf = 0;
    nbits = 0;
    hit_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return true;
      }
      ++p;
    }
    return false;
  }
};

int decode_sym(BitReader& br, const DecTable& t) {
  int code = br.bit();
  int l = 1;
  while (l <= 16 && code > t.maxcode[l]) {
    code = (code << 1) | br.bit();
    ++l;
  }
  if (l > 16) return -1;
  return t.vals[t.valptr[l] + code - t.mincode[l]];
}

inline int extend(int v, int s) {
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(EncTable& t, const uint8_t* bits, const uint8_t* vals) {
  std::memset(t.size, 0, sizeof(t.size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      t.code[vals[k]] = (uint16_t)code++;
      t.size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  long cap;
  long n = 0;
  uint32_t buf = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n >= cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
  }
  void put(uint32_t v, int size) {
    for (int i = size - 1; i >= 0; --i) {
      buf = (buf << 1) | ((v >> i) & 1);
      if (++nbits == 8) {
        byte((uint8_t)buf);
        if ((buf & 0xFF) == 0xFF) byte(0);
        buf = 0;
        nbits = 0;
      }
    }
  }
  void flush() {  // pad with 1 bits
    if (nbits) put((1u << (8 - nbits)) - 1, 8 - nbits);
  }
};

inline int nbits_of(int v) {
  v = v < 0 ? -v : v;
  int s = 0;
  while (v) {
    ++s;
    v >>= 1;
  }
  return s;
}

}  // namespace

extern "C" {

// Decode one baseline scan into quantised coefficients (natural order).
// The scan has `ncomp` components, component c with sampling factors
// (h[c], v[c]) in the MCU and tables dc[c], ac[c]; `mcux` x `mcuy` MCUs,
// a restart marker every `restart` MCUs (0: none). Component c's blocks
// form a grid `bw[c]` blocks wide at coefs + off[c], 64 int16 a block.
// Returns 0, or -1 on a bad Huffman code, -2 on a missing table.
int jpeg_decode_scan(const uint8_t* data, long len, int ncomp, const int* h,
                     const int* v, const int* dc, const int* ac,
                     const uint8_t* bits, const uint8_t* vals, int mcux,
                     int mcuy, int restart, int16_t* coefs, const long* off,
                     const int* bw) {
  DecTable tabs[8];
  for (int t = 0; t < 8; ++t)
    build_dec(tabs[t], bits + 16 * t, vals + 256 * t);
  for (int c = 0; c < ncomp; ++c)
    if (!tabs[dc[c]].present || !tabs[4 + ac[c]].present) return -2;
  BitReader br{data, data + len};
  int pred[4] = {0, 0, 0, 0};
  long n_mcu = (long)mcux * mcuy;
  for (long m = 0; m < n_mcu; ++m) {
    if (restart && m && m % restart == 0) {
      br.restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    int my = (int)(m / mcux), mx = (int)(m % mcux);
    for (int c = 0; c < ncomp; ++c) {
      const DecTable& tdc = tabs[dc[c]];
      const DecTable& tac = tabs[4 + ac[c]];
      for (int by = 0; by < v[c]; ++by) {
        for (int bx = 0; bx < h[c]; ++bx) {
          long row = (long)my * v[c] + by, col = (long)mx * h[c] + bx;
          int16_t* blk = coefs + off[c] + (row * bw[c] + col) * 64;
          std::memset(blk, 0, 64 * sizeof(int16_t));
          int s = decode_sym(br, tdc);
          if (s < 0) return -1;
          pred[c] += extend(br.get(s), s);
          blk[0] = (int16_t)pred[c];
          for (int k = 1; k < 64;) {
            int rs = decode_sym(br, tac);
            if (rs < 0) return -1;
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              if (k > 63) return -1;
              blk[kZigzag[k]] = (int16_t)extend(br.get(sz), sz);
              ++k;
            } else {
              if (r != 15) break;
              k += 16;
            }
          }
        }
      }
    }
  }
  return 0;
}

// Encode quantised coefficients (natural order, laid out as
// jpeg_decode_scan's output) as one baseline scan with no restarts.
// Returns the bytes written to `out`, or -1 when `cap` is too small.
long jpeg_encode_scan(int ncomp, const int* h, const int* v, const int* dc,
                      const int* ac, const uint8_t* bits, const uint8_t* vals,
                      int mcux, int mcuy, const int16_t* coefs,
                      const long* off, const int* bw, uint8_t* out,
                      long cap) {
  EncTable tabs[8];
  for (int t = 0; t < 8; ++t)
    build_enc(tabs[t], bits + 16 * t, vals + 256 * t);
  BitWriter bw_{out, cap};
  int pred[4] = {0, 0, 0, 0};
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        const EncTable& tdc = tabs[dc[c]];
        const EncTable& tac = tabs[4 + ac[c]];
        for (int by = 0; by < v[c]; ++by) {
          for (int bx = 0; bx < h[c]; ++bx) {
            long row = (long)my * v[c] + by, col = (long)mx * h[c] + bx;
            const int16_t* blk = coefs + off[c] + (row * bw[c] + col) * 64;
            int diff = blk[0] - pred[c];
            pred[c] = blk[0];
            int s = nbits_of(diff);
            bw_.put(tdc.code[s], tdc.size[s]);
            if (s) bw_.put((uint32_t)(diff < 0 ? diff - 1 : diff) &
                               ((1u << s) - 1), s);
            int run = 0;
            for (int k = 1; k < 64; ++k) {
              int a = blk[kZigzag[k]];
              if (a == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                bw_.put(tac.code[0xF0], tac.size[0xF0]);
                run -= 16;
              }
              int sz = nbits_of(a);
              int sym = (run << 4) | sz;
              bw_.put(tac.code[sym], tac.size[sym]);
              bw_.put((uint32_t)(a < 0 ? a - 1 : a) & ((1u << sz) - 1), sz);
              run = 0;
            }
            if (run) bw_.put(tac.code[0], tac.size[0]);
          }
        }
      }
    }
  }
  bw_.flush();
  return bw_.overflow ? -1 : bw_.n;
}

// Undo PNG row filtering: `data` holds `height` rows, each a filter-type
// byte and `rowbytes` bytes; `bpp` bytes a pixel (at least 1). Writes
// height x rowbytes bytes to `out`. Returns 0, or -1 on a bad filter type.
int png_unfilter(const uint8_t* data, int height, long rowbytes, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = data + (long)y * (rowbytes + 1);
    int ft = src[0];
    ++src;
    uint8_t* dst = out + (long)y * rowbytes;
    const uint8_t* up = y ? out + (long)(y - 1) * rowbytes : nullptr;
    for (long i = 0; i < rowbytes; ++i) {
      int a = i >= bpp ? dst[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int x = src[i], pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      dst[i] = (uint8_t)(x + pred);
    }
  }
  return 0;
}

// cv::undistort(src, dst, K, D) on a uint8 image of `cn` channels (1 or
// 3), with the new camera matrix K: the 5-coefficient model (k1, k2, p1,
// p2, k3) evaluated in double at each destination pixel, rounded to 1/32
// pixel (cvRound, half to even), then remap's INTER_LINEAR on 15-bit
// weights with BORDER_CONSTANT 0. As OpenCV does, the map is made in
// stripes of max(1, 4096 / W) rows, each with K's cy moved by the
// stripe's first row, and the inverse of K is the 3x3 cofactor formula.
// K is row-major (9 doubles), D 5 doubles.
void undistort_u8(const uint8_t* src, int height, int width, int cn,
                  const double* K, const double* D, uint8_t* dst) {
  // the bilinear table: weights (32 - ty)(32 - tx) 32 ... as shorts, the
  // corner weight 32768 saturated to 32767 and the deficit put on the
  // fourth tap, as cv::initInterTab2D leaves it
  static int tab[1024][4];
  static bool tab_ready = false;
  if (!tab_ready) {
    for (int ty = 0; ty < 32; ++ty)
      for (int tx = 0; tx < 32; ++tx) {
        int* w = tab[ty * 32 + tx];
        w[0] = (32 - ty) * (32 - tx) * 32;
        w[1] = (32 - ty) * tx * 32;
        w[2] = ty * (32 - tx) * 32;
        w[3] = ty * tx * 32;
        int sum = 0;
        for (int k = 0; k < 4; ++k) {
          if (w[k] > 32767) w[k] = 32767;
          sum += w[k];
        }
        w[3] += 32768 - sum;
      }
    tab_ready = true;
  }
  const double fx = K[0], u0 = K[2], fy = K[4], v0 = K[5];
  const double k1 = D[0], k2 = D[1], p1 = D[2], p2 = D[3], k3 = D[4];
  int stripe = 4096 / (width > 1 ? width : 1);
  if (stripe < 1) stripe = 1;
  if (stripe > height) stripe = height;
  for (int y0 = 0; y0 < height; y0 += stripe) {
    // the inverse of Ar = K with Ar(1, 2) = v0 - y0, by cofactors
    double a[9];
    for (int k = 0; k < 9; ++k) a[k] = K[k];
    a[5] = v0 - y0;
    double det = a[0] * (a[4] * a[8] - a[7] * a[5])
        - a[1] * (a[3] * a[8] - a[6] * a[5])
        + a[2] * (a[3] * a[7] - a[6] * a[4]);
    double d = 1. / det;
    double ir[9] = {
        (a[4] * a[8] - a[5] * a[7]) * d, (a[2] * a[7] - a[1] * a[8]) * d,
        (a[1] * a[5] - a[2] * a[4]) * d, (a[5] * a[6] - a[3] * a[8]) * d,
        (a[0] * a[8] - a[2] * a[6]) * d, (a[2] * a[3] - a[0] * a[5]) * d,
        (a[3] * a[7] - a[4] * a[6]) * d, (a[1] * a[6] - a[0] * a[7]) * d,
        (a[0] * a[4] - a[1] * a[3]) * d};
    int rows = height - y0 < stripe ? height - y0 : stripe;
    for (int i = 0; i < rows; ++i) {
      double _x = i * ir[1] + ir[2], _y = i * ir[4] + ir[5],
             _w = i * ir[7] + ir[8];
      uint8_t* out = dst + ((long)(y0 + i) * width) * cn;
      for (int j = 0; j < width; ++j, _x += ir[0], _y += ir[3],
               _w += ir[6]) {
        double w = 1. / _w, x = _x * w, yy = _y * w;
        double x2 = x * x, y2 = yy * yy;
        double r2 = x2 + y2, _2xy = 2 * x * yy;
        // OpenCV's rational and thin-prism terms and its tilt are
        // exact no-ops at zero coefficients and are left out
        double kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2;
        double xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2);
        double yd = yy * kr + p1 * (r2 + 2 * y2) + p2 * _2xy;
        long iu = std::lrint((fx * xd + u0) * 32.);
        long iv = std::lrint((fy * yd + v0) * 32.);
        int sx = (short)(iu >> 5), sy = (short)(iv >> 5);
        const int* wt = tab[(iv & 31) * 32 + (iu & 31)];
        int taps[4][2] = {{sy, sx}, {sy, sx + 1}, {sy + 1, sx},
                          {sy + 1, sx + 1}};
        for (int c = 0; c < cn; ++c) {
          int sum = 0;
          for (int k = 0; k < 4; ++k) {
            int ty = taps[k][0], tx = taps[k][1];
            if (ty >= 0 && ty < height && tx >= 0 && tx < width)
              sum += src[((long)ty * width + tx) * cn + c] * wt[k];
          }
          int v = (sum + (1 << 14)) >> 15;
          out[j * cn + c] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
      }
    }
  }
}

}  // extern "C"
