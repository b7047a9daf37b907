// A baseline JPEG decoder whose 8-bit samples equal libjpeg-turbo's default
// decode (islow IDCT, fancy upsampling, integer YCbCr->RGB) bit for bit.
//
// Decodes sequential Huffman files (SOF0, and SOF1 with 8-bit samples): 8-
// and 16-bit quantization tables, restart intervals, one or three
// components, interleaved scans or one scan per component. APPn and COM
// segments are skipped, apart from the JFIF and Adobe markers that decide
// the colour space as jdapimin.c does. EXIF orientation is not applied.
//
// The arithmetic follows libjpeg: jidctint.c (jpeg_idct_islow, CONST_BITS
// 13, PASS1_BITS 2, the post-IDCT range-limit table of jdmaster.c),
// jdsample.c's fancy upsampling (h2v1 and h2v2 when the component is more
// than 2 samples wide, h1v2; edge rows and columns replicated; other
// factors by replication) and jdcolor.c's YCbCr tables (SCALEBITS 16).
//
// C interface (ctypes):
//   int jpeg_header(data, size, dims[3], msg, msg_len)  -> H, W, channels
//   int jpeg_decode(data, size, out, msg, msg_len)      -> H x W x channels
// Both return 0, or 1 for a kind of JPEG this decoder does not take, or 2
// for a malformed file, with a message in msg.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end lands here, as in libjpeg
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int code;
  std::string msg;
};

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  int lookup[1 << 9];  // 9-bit lookahead: (length << 8) | value, 0 when longer
};

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks a row and rows of blocks, padded to whole MCUs
  int ds_w, ds_h;      // the component's own size in samples
  std::vector<int16_t> coef;  // bh * bw blocks of 64 coefficients, natural order
  std::vector<uint16_t> qt;   // the table latched at its first scan
  int pred = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  std::vector<Component> comps;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  // bit reader
  uint64_t bits = 0;
  int nbits = 0, eof_bits = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  [[noreturn]] void fail(int code, const std::string& msg) { throw Error{code, msg}; }
  void malformed(const std::string& msg) { fail(2, msg); }

  int byte() {
    if (pos >= n) malformed("unexpected end of data");
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker, skipping fill bytes (FF FF ...)
  int next_marker() {
    int c = byte();
    if (c != 0xFF) malformed("expected a marker");
    do {
      c = byte();
    } while (c == 0xFF);
    if (c == 0) malformed("a stuffed zero where a marker belongs");
    return c;
  }

  void unsupported_sof(int m) {
    if (m == 0xC2 || m == 0xC6) fail(1, "progressive");
    if (m == 0xC3 || m == 0xC7) fail(1, "lossless");
    if (m == 0xC5) fail(1, "hierarchical");
    if (m >= 0xC9) fail(1, "arithmetic-coded");
  }

  void read_sof(int marker) {
    int len = word();
    size_t end = pos + len - 2;
    int precision = byte();
    height = word();
    width = word();
    int nc = byte();
    if (precision != 8) fail(1, std::to_string(precision) + "-bit samples");
    if (nc == 4) fail(1, "4-component (CMYK/YCCK)");
    if (nc != 1 && nc != 3) fail(1, std::to_string(nc) + "-component");
    if (height <= 0 || width <= 0) malformed("an image with no rows or columns (DNL is not read)");
    (void)marker;
    comps.resize(nc);
    hmax = vmax = 1;
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) malformed("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (pos != end) malformed("bad SOF length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.ds_w = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.ds_h = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_dht() {
    int len = word();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) malformed("bad Huffman table id");
      Huffman& t = tc == 0 ? dc[th] : ac[th];
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256) malformed("bad Huffman table");
      for (int i = 0; i < total; ++i) t.vals[i] = (uint8_t)byte();
      // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
      int code = 0, k = 0;
      std::memset(t.lookup, 0, sizeof(t.lookup));
      for (int l = 1; l <= 16; ++l) {
        t.valoffset[l] = k - code;
        for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int f = 0; f < (1 << shift); ++f) t.lookup[(code << shift) | f] = (l << 8) | t.vals[k];
          }
        }
        t.maxcode[l] = counts[l] ? code - 1 : -1;
        if (code > (1 << l)) malformed("bad Huffman table");
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.defined = true;
    }
    if (pos != end) malformed("bad DHT length");
  }

  void read_dqt() {
    int len = word();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) malformed("bad quantization table");
      for (int i = 0; i < 64; ++i) qtables[tq][kNaturalOrder[i]] = (uint16_t)(pq ? word() : byte());
      qdefined[tq] = true;
    }
    if (pos != end) malformed("bad DQT length");
  }

  void read_app(int marker) {
    int len = word();
    if (len < 2) malformed("bad segment length");
    size_t end = pos + len - 2;
    if (end > n) malformed("unexpected end of data");
    size_t body = len - 2;
    // jdmarker.c examine_app0 / examine_app14
    if (marker == 0xE0 && body >= 14 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && body >= 12 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  void skip_segment() {
    int len = word();
    if (len < 2 || pos + len - 2 > n) malformed("bad segment length");
    pos += len - 2;
  }

  // ---- entropy-coded data
  void fill() {
    while (nbits <= 56) {
      int c = 0;
      if (!hit_marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          int c2 = pos + 1 < n ? d[pos + 1] : -1;
          if (c2 == 0) {
            pos += 2;
          } else {  // a marker: leave it, feed zeros as libjpeg does
            hit_marker = true;
            c = 0;
          }
        } else {
          pos += 1;
        }
      } else if (!hit_marker) {
        eof_bits += 8;  // past the end of the file: zeros that no decode may use
      }
      bits |= (uint64_t)c << (56 - nbits);
      nbits += 8;
    }
  }
  // a libjpeg-style decode runs on zeros past a marker; past the end of the file it is truncated
  void check_end() {
    if (nbits < eof_bits) malformed("the file ends inside its entropy-coded data (truncated)");
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = (int)(bits >> (64 - k));
    bits <<= k;
    nbits -= k;
    check_end();
    return v;
  }
  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    int look = t.lookup[bits >> (64 - 9)];
    if (look) {
      int l = look >> 8;
      bits <<= l;
      nbits -= l;
      check_end();
      return look & 0xFF;
    }
    int code = get_bits(9);
    int l = 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) malformed("bad Huffman code");
    }
    return t.vals[code + t.valoffset[l]];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void decode_block(Component& c, const Huffman& tdc, const Huffman& tac, int16_t* blk) {
    int s = decode(tdc);
    if (s > 15) malformed("bad DC difference");
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode(tac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNaturalOrder[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart() {
    // drop the bits left of the last byte, then read the RSTn marker
    bits = 0;
    nbits = eof_bits = 0;
    hit_marker = false;
    // jdmarker.c read_restart_marker: bytes before the marker are skipped
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) ++pos;
    int m = next_marker();
    if (m < 0xD0 || m > 0xD7) malformed("expected a restart marker");
    for (auto& c : comps) c.pred = 0;
  }

  void read_sos() {
    if (!frame) malformed("a scan before the frame header");
    int len = word();
    size_t end = pos + len - 2;
    int ns = byte();
    if (ns < 1 || ns > 4) malformed("bad scan header");
    std::vector<int> idx(ns);
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int t = byte();
      idx[i] = -1;
      for (size_t j = 0; j < comps.size(); ++j)
        if (comps[j].id == id) idx[i] = (int)j;
      if (idx[i] < 0) malformed("a scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
        malformed("a scan uses an undefined Huffman table");
    }
    byte();  // Ss
    byte();  // Se
    byte();  // Ah, Al
    if (pos != end) malformed("bad SOS length");
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[idx[i]];
      if (c.qt.empty()) {  // latch_quant_tables
        if (!qdefined[c.tq]) malformed("a component's quantization table is not defined");
        c.qt.assign(qtables[c.tq], qtables[c.tq] + 64);
      }
      c.pred = 0;
    }
    bits = 0;
    nbits = eof_bits = 0;
    hit_marker = false;
    long done = 0;
    auto maybe_restart = [&](long total) {
      ++done;
      if (restart_interval && done % restart_interval == 0 && done < total) restart();
    };
    if (ns == 1) {  // non-interleaved: one block an MCU, the component's own blocks
      Component& c = comps[idx[0]];
      int bw = (c.ds_w + 7) / 8, bh = (c.ds_h + 7) / 8;
      long total = (long)bw * bh;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          decode_block(c, dc[td[0]], ac[ta[0]], &c.coef[((size_t)by * c.bw + bx) * 64]);
          maybe_restart(total);
        }
    } else {
      long total = (long)mcux * mcuy;
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component& c = comps[idx[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                size_t b = (size_t)(my * c.v + y) * c.bw + (mx * c.h + x);
                decode_block(c, dc[td[i]], ac[ta[i]], &c.coef[b * 64]);
              }
          }
          maybe_restart(total);
        }
    }
    // back to the byte after the entropy-coded data: the next marker
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse(bool headers_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) malformed("no SOI marker");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        if (frame) malformed("a second frame header");
        read_sof(m);
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        unsupported_sof(m);
      } else if (m == 0xCC) {
        fail(1, "arithmetic-coded");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (word() != 4) malformed("bad DRI length");
        restart_interval = word();
      } else if (m == 0xDA) {
        if (headers_only) return;
        read_sos();
      } else if (m == 0xD9) {
        if (!frame) malformed("no frame header");
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD) || m == 0xDC || m == 0xDE || m == 0xDF) {
        skip_segment();
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker outside a scan: libjpeg skips it
      } else {
        malformed("unexpected marker");
      }
    }
  }

  bool rgb_space() const {  // jdapimin.c default_decompress_parms, 3 components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

// ---- jidctint.c: jpeg_idct_islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
           FIX_0_899976223 = 7373, FIX_1_175875602 = 9633, FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
           FIX_1_961570560 = 16069, FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// jdmaster.c prepare_range_limit_table, from the IDCT's point of view:
// the entry for a descaled value x is table[x & 1023]
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      // simple part (x + 128 for x in [-128, 127]), then 255 up to 511, 0
      // from 512 until the wrap brings back [-128, -1]
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (int)((long)ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    long z2 = (long)ip[16] * qp[16], z3 = (long)ip[48] * qp[48];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (long)ip[0] * qp[0];
    z3 = (long)ip[32] * qp[32];
    long tmp0 = (z2 + z3) * (1L << CONST_BITS);
    long tmp1 = (z2 - z3) * (1L << CONST_BITS);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (long)ip[56] * qp[56];
    tmp1 = (long)ip[40] * qp[40];
    tmp2 = (long)ip[24] * qp[24];
    tmp3 = (long)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange.t[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * -FIX_1_847759065;
    long tmp3 = z1 + z2 * FIX_0_765366865;
    long tmp0 = ((long)wp[0] + wp[4]) * (1L << CONST_BITS);
    long tmp1 = ((long)wp[0] - wp[4]) * (1L << CONST_BITS);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
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
    op[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// a component's samples, (ds_h, ds_w), from its coefficients
std::vector<uint8_t> component_plane(const Component& c) {
  if (c.qt.empty()) throw Error{2, "a component no scan decoded"};
  int pw = c.bw * 8;
  std::vector<uint8_t> full((size_t)c.bh * 8 * pw);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.qt.data(), &full[(size_t)by * 8 * pw + bx * 8], pw);
  std::vector<uint8_t> out((size_t)c.ds_h * c.ds_w);
  for (int y = 0; y < c.ds_h; ++y) std::memcpy(&out[(size_t)y * c.ds_w], &full[(size_t)y * pw], c.ds_w);
  return out;
}

// jdsample.c: the plane (h, w) upsampled by (fh, fv) to (h * fv, w * fh)
std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int h, int w, int fh, int fv) {
  if (fh == 1 && fv == 1) return in;
  int ow = w * fh, oh = h * fv;
  std::vector<uint8_t> out((size_t)oh * ow);
  auto row = [&](int y) { return &in[(size_t)std::min(std::max(y, 0), h - 1) * w]; };
  if (fh == 2 && fv == 1 && w > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < h; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = &out[(size_t)y * ow];
      op[0] = ip[0];
      op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < w - 1; ++x) {
        int v = ip[x] * 3;
        op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      op[2 * w - 2] = (uint8_t)((ip[w - 1] * 3 + ip[w - 2] + 1) >> 2);
      op[2 * w - 1] = ip[w - 1];
    }
    return out;
  }
  if (fh == 2 && fv == 2 && w > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < h; ++y)
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(y);
        const uint8_t* i1 = row(v == 0 ? y - 1 : y + 1);
        uint8_t* op = &out[(size_t)(2 * y + v) * ow];
        int this_s = i0[0] * 3 + i1[0], next_s = i0[1] * 3 + i1[1], last_s;
        op[0] = (uint8_t)((this_s * 4 + 8) >> 4);
        op[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
        for (int x = 1; x < w - 1; ++x) {
          next_s = i0[x + 1] * 3 + i1[x + 1];
          op[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          op[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        op[2 * w - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        op[2 * w - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
      }
    return out;
  }
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < h; ++y)
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(y);
        const uint8_t* i1 = row(v == 0 ? y - 1 : y + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t* op = &out[(size_t)(2 * y + v) * ow];
        for (int x = 0; x < w; ++x) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
      }
    return out;
  }
  // h2v1_upsample, h2v2_upsample, int_upsample: replication
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) out[(size_t)y * ow + x] = in[(size_t)(y / fv) * w + x / fh];
  return out;
}

// jdcolor.c build_ycc_rgb_table, ycc_rgb_convert
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const long ONE_HALF = 1L << (SCALEBITS - 1);
    auto fix = [](double x) { return (long)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void decode_image(Decoder& dec, uint8_t* out) {
  int H = dec.height, W = dec.width;
  std::vector<std::vector<uint8_t>> planes;
  for (auto& c : dec.comps) {
    std::vector<uint8_t> p = component_plane(c);
    int fh = dec.hmax / c.h, fv = dec.vmax / c.v;
    if (fh * c.h != dec.hmax || fv * c.v != dec.vmax) throw Error{1, "fractional sampling factors"};
    std::vector<uint8_t> u = upsample(p, c.ds_h, c.ds_w, fh, fv);
    int uw = c.ds_w * fh;
    std::vector<uint8_t> crop((size_t)H * W);
    for (int y = 0; y < H; ++y) std::memcpy(&crop[(size_t)y * W], &u[(size_t)y * uw], W);
    planes.push_back(std::move(crop));
  }
  size_t npix = (size_t)H * W;
  if (planes.size() == 1) {
    std::memcpy(out, planes[0].data(), npix);
    return;
  }
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
  if (dec.rgb_space()) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return;
  }
  for (size_t i = 0; i < npix; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
}

int report(const Error& e, char* msg, int msg_len) {
  if (msg_len > 0) std::snprintf(msg, (size_t)msg_len, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, long size, int* dims, char* msg, int msg_len) {
  try {
    Decoder dec(data, (size_t)size);
    dec.parse(true);
    if (!dec.frame) throw Error{2, "no frame header before the first scan"};
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = (int)dec.comps.size();
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  }
}

int jpeg_decode(const uint8_t* data, long size, uint8_t* out, char* msg, int msg_len) {
  try {
    Decoder dec(data, (size_t)size);
    dec.parse(false);
    decode_image(dec, out);
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{2, "out of memory"}, msg, msg_len);
  }
}

}  // extern "C"
