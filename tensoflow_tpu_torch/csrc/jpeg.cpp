// Baseline JPEG scans (ITU T.81, sequential Huffman, 8-bit), decoded and
// entropy-coded.
//
// Host C++ for tensoflow_tpu_torch/data/image_io.py, the two loops that
// numpy cannot vectorise:
//   jpeg_decode_scan: one scan's entropy-coded data into component sample
//     planes, each 8x8 block dequantized and inverted with libjpeg's
//     accurate integer IDCT (jidctint.c, jpeg_idct_islow), so the samples
//     equal libjpeg's;
//   jpeg_encode_scan: quantized blocks (the forward DCT and quantization
//     are numpy) into Huffman-coded scan data.
// Markers, tables, sampling and colour conversion stay in Python.  Built
// with g++ into build/kernels/ at first use and bound with ctypes.
#include <cstdint>
#include <cstring>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  const uint8_t* vals;
  bool present;
};

// bits[1..16]: the number of codes of each length (bits[0] unused).
void build_huff(Huff* h, const uint8_t* bits, const uint8_t* vals) {
  int code = 0, k = 0;
  h->present = false;
  for (int l = 1; l <= 16; ++l) {
    h->valptr[l] = k;
    h->mincode[l] = code;
    code += bits[l];
    k += bits[l];
    h->maxcode[l] = bits[l] ? code - 1 : -1;
    code <<= 1;
    if (bits[l]) h->present = true;
  }
  h->maxcode[17] = 0x7fffffff;
  h->vals = vals;
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int n = 0;           // bits in acc
  bool marker = false; // hit a marker: feed zeros from here

  int bit() {
    if (n == 0) {
      int b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          int nxt = p + 1 < end ? p[1] : 0xD9;
          if (nxt == 0x00) {
            p += 2;
          } else {           // a marker: it stays for the restart logic
            marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc = static_cast<uint32_t>(b);
      n = 8;
    }
    --n;
    return (acc >> n) & 1;
  }
  int bits(int s) {
    int v = 0;
    for (int i = 0; i < s; ++i) v = (v << 1) | bit();
    return v;
  }
  // skip to the next RSTn marker and past it; false if none is there
  bool restart() {
    n = 0;
    marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
      ++p;
    if (p + 1 >= end) return false;
    p += 2;
    return true;
  }
};

int decode(Reader* r, const Huff* h) {
  int code = r->bit();
  int l = 1;
  while (code > h->maxcode[l]) {
    code = (code << 1) | r->bit();
    if (++l > 16) return -1;
  }
  return h->vals[h->valptr[l] + code - h->mincode[l]];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow; out: 8 rows of `stride` samples.
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
              F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
              F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t range_limit(int64_t v) {
  const int64_t i = v & 1023;      // RANGE_MASK of the post-IDCT table
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qc = q + c;
    int64_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int64_t dc = (int64_t(in[0]) * qc[0]) << 2;
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qc[16], z3 = int64_t(in[48]) * qc[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(in[0]) * qc[0];
    z3 = int64_t(in[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) << 13, tmp1 = (z2 - z3) << 13;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                  tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qc[56];
    tmp1 = int64_t(in[40]) * qc[40];
    tmp2 = int64_t(in[24]) * qc[24];
    tmp3 = int64_t(in[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = descale(tmp10 + tmp3, 11);
    w[56] = descale(tmp10 - tmp3, 11);
    w[8] = descale(tmp11 + tmp2, 11);
    w[48] = descale(tmp11 - tmp2, 11);
    w[16] = descale(tmp12 + tmp1, 11);
    w[40] = descale(tmp12 - tmp1, 11);
    w[24] = descale(tmp13 + tmp0, 11);
    w[32] = descale(tmp13 - tmp0, 11);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (w[0] + w[4]) << 13, tmp1 = (w[0] - w[4]) << 13;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                  tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range_limit(descale(tmp10 + tmp3, 18));
    o[7] = range_limit(descale(tmp10 - tmp3, 18));
    o[1] = range_limit(descale(tmp11 + tmp2, 18));
    o[6] = range_limit(descale(tmp11 - tmp2, 18));
    o[2] = range_limit(descale(tmp12 + tmp1, 18));
    o[5] = range_limit(descale(tmp12 - tmp1, 18));
    o[3] = range_limit(descale(tmp13 + tmp0, 18));
    o[4] = range_limit(descale(tmp13 - tmp0, 18));
  }
}

struct Writer {
  uint8_t* out;
  int64_t cap, n = 0;
  uint32_t acc = 0;
  int bits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;            // byte stuffing
  }
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      byte(static_cast<uint8_t>(acc >> bits));
    }
    acc &= (1u << bits) - 1;
  }
  void flush() {                                // pad with 1-bits
    if (bits) put((1u << (8 - bits)) - 1, 8 - bits);
  }
};

inline int bit_length(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}


}  // namespace

extern "C" {

// One scan of `ncomp` components (interleaved when ncomp > 1; a single
// component is coded block by block over mcux x mcuy blocks).
// hs, vs: sampling factors (1, 1 for a single-component scan); dc, ac:
// Huffman table slots; qt: [ncomp][64] quantizers in natural order;
// bits: [8][17] (slots 0-3 DC, 4-7 AC), vals: [8][256]; planes[c]: a
// uint8 plane of stride strides[c] holding mcux*hs*8 x mcuy*vs*8 samples.
// Returns 0, -1 on a bad Huffman code, -2 on a missing restart marker,
// -3 on a missing table.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int32_t ncomp,
                         const int32_t* hs, const int32_t* vs,
                         const int32_t* dc, const int32_t* ac,
                         const uint16_t* qt, const uint8_t* bits,
                         const uint8_t* vals, int32_t mcux, int32_t mcuy,
                         int32_t restart_interval, uint8_t** planes,
                         const int64_t* strides) {
  Huff tabs[8];
  for (int t = 0; t < 8; ++t) build_huff(&tabs[t], bits + 17 * t,
                                         vals + 256 * t);
  for (int c = 0; c < ncomp; ++c)
    if (!tabs[dc[c]].present || !tabs[4 + ac[c]].present) return -3;
  Reader r{data, data + len};
  int pred[4] = {0, 0, 0, 0};
  int16_t coef[64];
  int64_t mcu = 0;
  for (int32_t my = 0; my < mcuy; ++my) {
    for (int32_t mx = 0; mx < mcux; ++mx, ++mcu) {
      if (restart_interval && mcu && mcu % restart_interval == 0) {
        if (!r.restart()) return -2;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      for (int c = 0; c < ncomp; ++c) {
        for (int v = 0; v < vs[c]; ++v) {
          for (int h = 0; h < hs[c]; ++h) {
            std::memset(coef, 0, sizeof(coef));
            int s = decode(&r, &tabs[dc[c]]);
            if (s < 0) return -1;
            pred[c] += s ? extend(r.bits(s), s) : 0;
            coef[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64;) {
              const int rs = decode(&r, &tabs[4 + ac[c]]);
              if (rs < 0) return -1;
              const int run = rs >> 4, size = rs & 15;
              if (size) {
                k += run;
                if (k > 63) return -1;
                coef[kZigzag[k]] =
                    static_cast<int16_t>(extend(r.bits(size), size));
                ++k;
              } else if (run == 15) {
                k += 16;
              } else {
                break;
              }
            }
            const int64_t row = (int64_t(my) * vs[c] + v) * 8;
            const int64_t col = (int64_t(mx) * hs[c] + h) * 8;
            idct_islow(coef, qt + 64 * c,
                       planes[c] + row * strides[c] + col, strides[c]);
          }
        }
      }
    }
  }
  return 0;
}


// blocks: [nblocks][64] quantized coefficients (natural order) in scan
// order; comp: each block's component (0-2), whose DC / AC code tables
// are dc_slot[comp] / ac_slot[comp] in codes, sizes: [4][256].  Writes
// the stuffed, 1-padded scan data to out; returns its length, or -1 if
// it does not fit in cap bytes.
int64_t jpeg_encode_scan(const int16_t* blocks, const int32_t* comp,
                         int64_t nblocks, const int32_t* dc_slot,
                         const int32_t* ac_slot, const uint16_t* codes,
                         const uint8_t* sizes, uint8_t* out, int64_t cap) {
  Writer w{out, cap};
  int pred[3] = {0, 0, 0};
  for (int64_t b = 0; b < nblocks; ++b) {
    const int16_t* q = blocks + 64 * b;
    const int c = comp[b];
    const uint16_t* dco = codes + 256 * dc_slot[c];
    const uint8_t* dsz = sizes + 256 * dc_slot[c];
    const uint16_t* aco = codes + 256 * ac_slot[c];
    const uint8_t* asz = sizes + 256 * ac_slot[c];
    const int diff = q[0] - pred[c];
    pred[c] = q[0];
    int nb = bit_length(diff);
    w.put(dco[nb], dsz[nb]);
    if (nb) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = q[kZigzag[k]];
      if (!v) {
        ++run;
        continue;
      }
      for (; run > 15; run -= 16) w.put(aco[0xF0], asz[0xF0]);
      nb = bit_length(v);
      w.put(aco[(run << 4) | nb], asz[(run << 4) | nb]);
      w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run) w.put(aco[0], asz[0]);
    if (w.overflow) return -1;
  }
  w.flush();
  return w.overflow ? -1 : w.n;
}

}  // extern "C"
