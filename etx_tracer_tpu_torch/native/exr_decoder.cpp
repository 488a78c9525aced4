// PIZ block decoder for the EXR reader (utils/image_io.py).
//
// Replaces the tinyexr PIZ path the reference links for ImagePool loads
// (reference render/host/image_pool.cxx:113). Implemented from the public
// OpenEXR file-format specification (wavelet + canonical Huffman over u16
// words, per-channel planes): this is an independent implementation, the
// algorithms are the published format.
//
// Exported:
//   etx_piz_decode(src, src_len, n_channels, ch_word_counts, width, n_lines,
//                  dst, dst_len) -> bytes written, or < 0 on error.
//
// Output layout matches an uncompressed EXR scanline block: for each line,
// for each channel (file order), width * (2 * words) bytes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBitmapSize = 1 << 16;   // 65536 u16 values
constexpr int kHufEncSize = 65537;
constexpr int kShortZerorun = 59;
constexpr int kLongZerorun = 63;
constexpr int kShortestLongRun = 2 + kLongZerorun - kShortZerorun;  // 6

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool fail = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  uint32_t get(int n) {
    while (nbits < n) {
      if (p >= end) {
        fail = true;
        return 0;
      }
      acc = (acc << 8) | *p++;
      nbits += 8;
    }
    nbits -= n;
    return uint32_t((acc >> nbits) & ((1ull << n) - 1));
  }
};

// --- canonical Huffman ----------------------------------------------------

// Unpack the 6-bit-packed code-length table, then assign canonical codes.
// hcode[i] ends up as (code << 6) | length.
static bool huf_unpack_enc_table(BitReader& br, int im, int iM,
                                 std::vector<uint64_t>& hcode) {
  hcode.assign(kHufEncSize, 0);
  for (; im <= iM; im++) {
    if (br.fail) return false;
    uint64_t l = br.get(6);
    hcode[im] = l;
    if (l == kLongZerorun) {
      int zerun = int(br.get(8)) + kShortestLongRun;
      if (im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    } else if (l >= kShortZerorun) {
      int zerun = int(l) - kShortZerorun + 2;
      if (im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    }
  }
  // canonical code assignment (longest codes get the smallest values)
  uint64_t n[59] = {0};
  for (int i = 0; i < kHufEncSize; i++) n[hcode[i]] += 1;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < kHufEncSize; i++) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = uint64_t(l) | (n[l]++ << 6);
  }
  return true;
}

// Single-level fast decode table over the top 14 bits, with a spill list
// for longer codes (the standard two-tier scheme).
constexpr int kDecBits = 14;
struct DecEntry {
  int32_t lit = 0;     // symbol when len > 0
  int16_t len = 0;     // code length, 0 = not a short code
  int32_t lit_begin = 0, lit_count = 0;  // long-code candidates
};

static bool huf_build_dec_table(const std::vector<uint64_t>& hcode,
                                int im, int iM,
                                std::vector<DecEntry>& dec,
                                std::vector<int32_t>& long_syms) {
  dec.assign(1 << kDecBits, DecEntry());
  // collect long codes per top-kDecBits prefix
  for (int sym = im; sym <= iM; sym++) {
    uint64_t code = hcode[sym] >> 6;
    int len = int(hcode[sym] & 63);
    if (len == 0) continue;
    if (len > 58) return false;
    if (len <= kDecBits) {
      // fill all table slots whose top bits equal the code
      uint64_t base = code << (kDecBits - len);
      uint64_t cnt = 1ull << (kDecBits - len);
      if (base + cnt > (1ull << kDecBits)) return false;
      for (uint64_t j = 0; j < cnt; j++) {
        DecEntry& e = dec[base + j];
        if (e.len) return false;  // overlapping codes: corrupt table
        e.len = int16_t(len);
        e.lit = sym;
      }
    } else {
      uint64_t prefix = code >> (len - kDecBits);
      DecEntry& e = dec[prefix];
      if (e.len) return false;
      e.lit_count++;  // counted first, filled in a second pass
    }
  }
  // second pass: bucket long codes
  int total = 0;
  for (auto& e : dec) {
    if (e.lit_count) {
      e.lit_begin = total;
      total += e.lit_count;
      e.lit_count = 0;
    }
  }
  long_syms.assign(total, 0);
  for (int sym = im; sym <= iM; sym++) {
    int len = int(hcode[sym] & 63);
    if (len > kDecBits) {
      uint64_t code = hcode[sym] >> 6;
      DecEntry& e = dec[code >> (len - kDecBits)];
      long_syms[e.lit_begin + e.lit_count++] = sym;
    }
  }
  return true;
}

static bool huf_decode(const std::vector<uint64_t>& hcode,
                       const std::vector<DecEntry>& dec,
                       const std::vector<int32_t>& long_syms,
                       const uint8_t* in, int64_t nbits, int rlc,
                       uint16_t* out, int64_t n_out) {
  uint64_t c = 0;
  int lc = 0;
  const uint8_t* p = in;
  const uint8_t* ie = in + (nbits + 7) / 8;
  int64_t no = 0;

  auto out_rle = [&](int count) -> bool {
    if (no == 0 || no + count > n_out) return false;
    uint16_t prev = out[no - 1];
    for (int k = 0; k < count; k++) out[no++] = prev;
    return true;
  };

  while (p < ie) {
    c = (c << 8) | *p++;
    lc += 8;
    while (lc >= kDecBits) {
      uint32_t idx = uint32_t((c >> (lc - kDecBits)) & ((1 << kDecBits) - 1));
      const DecEntry& e = dec[idx];
      if (e.len) {
        lc -= e.len;
        if (e.lit == rlc) {
          if (lc < 8) {
            if (p >= ie) return false;
            c = (c << 8) | *p++;
            lc += 8;
          }
          lc -= 8;
          if (!out_rle(int((c >> lc) & 0xff))) return false;
        } else {
          if (no >= n_out) return false;
          out[no++] = uint16_t(e.lit);
        }
      } else if (e.lit_count) {
        // long code: linear probe the bucket
        int k = 0;
        for (; k < e.lit_count; k++) {
          int sym = long_syms[e.lit_begin + k];
          int len = int(hcode[sym] & 63);
          if (len > lc) continue;
          uint64_t code = hcode[sym] >> 6;
          if (((c >> (lc - len)) & ((1ull << len) - 1)) == code) {
            lc -= len;
            if (sym == rlc) {
              if (lc < 8) {
                if (p >= ie) return false;
                c = (c << 8) | *p++;
                lc += 8;
              }
              lc -= 8;
              if (!out_rle(int((c >> lc) & 0xff))) return false;
            } else {
              if (no >= n_out) return false;
              out[no++] = uint16_t(sym);
            }
            break;
          }
        }
        if (k == e.lit_count) {
          // not enough bits buffered yet for any candidate: fetch more
          if (p < ie) break;
          return false;
        }
      } else {
        return false;  // invalid code
      }
    }
  }

  // drain remaining buffered bits (codes wholly inside the tail)
  int tail_unused = int((8 - nbits % 8) % 8);
  c >>= tail_unused;  // shift out the final byte's padding bits so valid bits sit at the bottom
  lc -= tail_unused;
  while (lc > 0) {
    uint32_t idx = uint32_t((c << (kDecBits - lc)) & ((1 << kDecBits) - 1));
    const DecEntry& e = dec[idx];
    if (e.len && e.len <= lc) {
      lc -= e.len;
      if (e.lit == rlc) {
        if (lc < 8) return false;
        lc -= 8;
        if (!out_rle(int((c >> lc) & 0xff))) return false;
      } else {
        if (no >= n_out) return false;
        out[no++] = uint16_t(e.lit);
      }
    } else {
      return false;
    }
  }
  return no == n_out;
}

// --- 2D wavelet -----------------------------------------------------------

inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = int16_t(l);
  int16_t hs = int16_t(h);
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = int16_t(ai);
  int16_t bs = int16_t(as - hi);
  a = uint16_t(as);
  b = uint16_t(bs);
}

constexpr int kModMask = (1 << 16) - 1;
constexpr int kAOffset = 1 << 15;

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l;
  int d = h;
  int bb = (m - (d >> 1)) & kModMask;
  int aa = (d + bb - kAOffset) & kModMask;
  b = uint16_t(bb);
  a = uint16_t(aa);
}

static void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy,
                        uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;

  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2;
    int ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;

    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, i00, *p10);
        else
          wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, i00, *p01);
        else
          wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// --- encode side (used for PIZ write support and roundtrip validation) -----

inline void wenc14(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int16_t as = int16_t(a);
  int16_t bs = int16_t(b);
  int16_t ms = int16_t((as + bs) >> 1);
  int16_t ds = int16_t(as - bs);
  l = uint16_t(ms);
  h = uint16_t(ds);
}

inline void wenc16(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int ao = (a + kAOffset) & kModMask;
  int m = (ao + b) >> 1;
  int d = ao - b;
  if (d < 0) m = (m + kAOffset) & kModMask;
  d &= kModMask;
  l = uint16_t(m);
  h = uint16_t(d);
}

static void wav2_encode(uint16_t* in, int nx, int ox, int ny, int oy,
                        uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = nx > ny ? ny : nx;
  int p = 1;   // == 1 << level
  int p2 = 2;  // == 1 << (level+1)

  while (p2 <= n) {
    uint16_t* py = in;
    uint16_t* ey = in + oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2;
    int ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;

    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wenc14(*px, *p01, i00, i01);
          wenc14(*p10, *p11, i10, i11);
          wenc14(i00, i10, *px, *p10);
          wenc14(i01, i11, *p01, *p11);
        } else {
          wenc16(*px, *p01, i00, i01);
          wenc16(*p10, *p11, i10, i11);
          wenc16(i00, i10, *px, *p10);
          wenc16(i01, i11, *p01, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wenc14(*px, *p10, i00, *p10);
        else
          wenc16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wenc14(*px, *p01, i00, *p01);
        else
          wenc16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p = p2;
    p2 <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void put(uint64_t bits, int n) {
    if (n > 32) {  // keep acc within 64 bits (codes may be up to 58 bits)
      put(bits >> 32, n - 32);
      n = 32;
    }
    acc = (acc << n) | (bits & ((1ull << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back(uint8_t((acc >> nbits) & 0xff));
    }
  }
  void flush() {
    if (nbits > 0) {
      out.push_back(uint8_t((acc << (8 - nbits)) & 0xff));
      nbits = 0;
    }
  }
};

// Heap-based Huffman length assignment (tree via parent pointers, lengths
// by depth from the root).
static void huf_build_lengths(const std::vector<uint64_t>& freq,
                              std::vector<int>& length) {
  int n = int(freq.size());
  length.assign(n, 0);
  std::vector<int> sym;
  for (int i = 0; i < n; i++)
    if (freq[i]) sym.push_back(i);
  if (sym.empty()) return;
  if (sym.size() == 1) {
    length[sym[0]] = 1;
    return;
  }
  int m = int(sym.size());
  // node ids: 0..m-1 leaves, m.. internal
  std::vector<uint64_t> f;
  f.reserve(2 * m);
  for (int i = 0; i < m; i++) f.push_back(freq[sym[i]]);
  std::vector<int> parent(2 * m - 1, -1);
  // min-heap of node ids by frequency
  std::vector<int> heap(m);
  for (int i = 0; i < m; i++) heap[i] = i;
  auto less = [&](int a, int b) { return f[a] > f[b]; };  // min-heap
  std::make_heap(heap.begin(), heap.end(), less);
  int next = m;
  while (heap.size() > 1) {
    std::pop_heap(heap.begin(), heap.end(), less);
    int a = heap.back();
    heap.pop_back();
    std::pop_heap(heap.begin(), heap.end(), less);
    int b = heap.back();
    heap.pop_back();
    f.push_back(f[a] + f[b]);
    parent[a] = next;
    parent[b] = next;
    heap.push_back(next++);
    std::push_heap(heap.begin(), heap.end(), less);
  }
  // depth of each leaf
  std::vector<int> depth(2 * m - 1, 0);
  for (int i = next - 2; i >= 0; i--) depth[i] = depth[parent[i]] + 1;
  for (int i = 0; i < m; i++) length[sym[i]] = depth[i];
}

static void huf_canonical_from_lengths(std::vector<uint64_t>& hcode) {
  uint64_t n[59] = {0};
  for (size_t i = 0; i < hcode.size(); i++) n[hcode[i]] += 1;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (size_t i = 0; i < hcode.size(); i++) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = uint64_t(l) | (n[l]++ << 6);
  }
}

static void huf_pack_enc_table(const std::vector<uint64_t>& hcode,
                               int im, int iM, BitWriter& bw) {
  for (int i = im; i <= iM; i++) {
    int l = int(hcode[i] & 63);
    if (l == 0) {
      // count zero run
      int run = 1;
      while (i + run <= iM && (hcode[i + run] & 63) == 0) run++;
      while (run >= kShortestLongRun) {
        int r = run > 255 + kShortestLongRun ? 255 + kShortestLongRun : run;
        bw.put(kLongZerorun, 6);
        bw.put(r - kShortestLongRun, 8);
        i += r;
        run -= r;
      }
      if (run > 1) {
        bw.put(kShortZerorun + run - 2, 6);
        i += run;
        run = 0;
      } else if (run == 1) {
        bw.put(0, 6);
        i += 1;
      }
      i -= 1;
    } else {
      bw.put(l, 6);
    }
  }
  bw.flush();
}

}  // namespace

extern "C" {

// PIZ-encode one scanline block. src = uncompressed block layout (per line,
// per channel, width*2*words bytes). Returns bytes written or <0 on error.
int64_t etx_piz_encode(const uint8_t* src, int64_t src_len,
                       int32_t n_channels, const int32_t* ch_words,
                       int32_t width, int32_t n_lines,
                       uint8_t* dst, int64_t dst_len) {
  int64_t words_per_line = 0;
  for (int c = 0; c < n_channels; c++) words_per_line += int64_t(width) * ch_words[c];
  int64_t total = words_per_line * n_lines;
  if (src_len < total * 2) return -1;

  // deinterleave scanlines into per-channel planes
  std::vector<uint16_t> tmp(total);
  std::vector<int64_t> plane_off(n_channels);
  {
    int64_t off = 0;
    for (int c = 0; c < n_channels; c++) {
      plane_off[c] = off;
      off += int64_t(width) * ch_words[c] * n_lines;
    }
    const uint8_t* s = src;
    for (int y = 0; y < n_lines; y++) {
      for (int c = 0; c < n_channels; c++) {
        int64_t row_words = int64_t(width) * ch_words[c];
        std::memcpy(tmp.data() + plane_off[c] + y * row_words, s, row_words * 2);
        s += row_words * 2;
      }
    }
  }

  // bitmap + forward LUT
  std::vector<uint8_t> bitmap(kBitmapSize / 8, 0);
  for (int64_t i = 0; i < total; i++) bitmap[tmp[i] >> 3] |= 1 << (tmp[i] & 7);
  bitmap[0] &= ~1;  // zero is always present implicitly
  std::vector<uint16_t> flut(kBitmapSize, 0);
  int k = 0;
  for (int i = 0; i < kBitmapSize; i++) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) flut[i] = uint16_t(k++);
  }
  uint16_t max_value = uint16_t(k - 1);
  for (int64_t i = 0; i < total; i++) tmp[i] = flut[tmp[i]];

  int min_nz = 0, max_nz = -1;
  for (int i = 0; i < kBitmapSize / 8; i++)
    if (bitmap[i]) {
      if (max_nz < 0) min_nz = i;
      max_nz = i;
    }
  if (max_nz < 0) {
    min_nz = 1;
    max_nz = 0;
  }

  // per-channel wavelet encode
  for (int c = 0; c < n_channels; c++) {
    int size = ch_words[c];
    for (int j = 0; j < size; j++)
      wav2_encode(tmp.data() + plane_off[c] + j, width, size, n_lines,
                  width * size, max_value);
  }

  // Huffman encode with an explicit RLE symbol (= iM)
  std::vector<uint64_t> freq(kHufEncSize, 0);
  for (int64_t i = 0; i < total; i++) freq[tmp[i]] += 1;
  // find iM before adding the run-length marker
  int data_max = 0;
  for (int i = 0; i < kHufEncSize; i++)
    if (freq[i]) data_max = i;
  int rlc = data_max + 1 < kHufEncSize ? data_max + 1 : data_max;
  // count runs toward the marker's frequency
  {
    int64_t i = 0;
    uint64_t marker = 0;
    while (i < total) {
      int64_t j = i + 1;
      while (j < total && tmp[j] == tmp[i] && j - i < 256) j++;
      if (j - i > 1) marker += 1;
      i = j;
    }
    if (rlc != data_max) freq[rlc] = marker ? marker : 1;
  }

  std::vector<int> lengths;
  huf_build_lengths(freq, lengths);
  for (auto l : lengths)
    if (l > 58) return -2;  // depth-limited codes not implemented
  std::vector<uint64_t> hcode(lengths.begin(), lengths.end());
  huf_canonical_from_lengths(hcode);

  int im = 0, iM = rlc;
  while (im < kHufEncSize && !freq[im]) im++;

  std::vector<uint8_t> table_bytes;
  {
    BitWriter bw(table_bytes);
    huf_pack_enc_table(hcode, im, iM, bw);
  }

  std::vector<uint8_t> data_bytes;
  int64_t nbits = 0;
  {
    BitWriter bw(data_bytes);
    int64_t i = 0;
    while (i < total) {
      int64_t j = i + 1;
      while (j < total && tmp[j] == tmp[i] && j - i < 256) j++;
      uint16_t s = tmp[i];
      bw.put(hcode[s] >> 6, int(hcode[s] & 63));
      nbits += int(hcode[s] & 63);
      int run = int(j - i - 1);
      if (run > 0 && rlc != data_max) {
        bw.put(hcode[rlc] >> 6, int(hcode[rlc] & 63));
        bw.put(run, 8);
        nbits += int(hcode[rlc] & 63) + 8;
        i = j;
      } else {
        i += 1;  // no marker available: emit symbols one by one
      }
    }
    bw.flush();
  }

  // assemble: minNZ, maxNZ, bitmap slice, int hufLen, huffman stream
  int bmp_n = max_nz >= min_nz ? max_nz - min_nz + 1 : 0;
  int64_t huf_len = 20 + int64_t(table_bytes.size()) + int64_t(data_bytes.size());
  int64_t out_len = 4 + bmp_n + 4 + huf_len;
  if (out_len > dst_len) return -3;

  uint8_t* d = dst;
  uint16_t mn = uint16_t(min_nz), mx = uint16_t(max_nz >= min_nz ? max_nz : 0);
  if (bmp_n == 0) {
    mn = 1;
    mx = 0;
  }
  std::memcpy(d, &mn, 2);
  std::memcpy(d + 2, &mx, 2);
  d += 4;
  if (bmp_n > 0) {
    std::memcpy(d, bitmap.data() + min_nz, bmp_n);
    d += bmp_n;
  }
  int32_t hl = int32_t(huf_len);
  std::memcpy(d, &hl, 4);
  d += 4;
  int32_t him = im, hiM = iM, htl = int32_t(table_bytes.size()),
          hnb = int32_t(nbits), hz = 0;
  std::memcpy(d, &him, 4);
  std::memcpy(d + 4, &hiM, 4);
  std::memcpy(d + 8, &htl, 4);
  std::memcpy(d + 12, &hnb, 4);
  std::memcpy(d + 16, &hz, 4);
  d += 20;
  std::memcpy(d, table_bytes.data(), table_bytes.size());
  d += table_bytes.size();
  std::memcpy(d, data_bytes.data(), data_bytes.size());
  d += data_bytes.size();
  return d - dst;
}

// ch_words[i]: u16 words per pixel for channel i (1 for HALF, 2 for
// FLOAT/UINT). Returns bytes written to dst or <0: -1 malformed, -2 dst
// too small, -3 huffman error.
int64_t etx_piz_decode(const uint8_t* src, int64_t src_len,
                       int32_t n_channels, const int32_t* ch_words,
                       int32_t width, int32_t n_lines,
                       uint8_t* dst, int64_t dst_len) {
  if (src_len < 4) return -1;
  const uint8_t* p = src;
  const uint8_t* pe = src + src_len;

  uint16_t min_nz, max_nz;
  std::memcpy(&min_nz, p, 2);
  std::memcpy(&max_nz, p + 2, 2);
  p += 4;
  if (max_nz >= kBitmapSize / 8) return -1;

  std::vector<uint8_t> bitmap(kBitmapSize / 8, 0);
  if (min_nz <= max_nz) {
    int n = max_nz - min_nz + 1;
    if (p + n > pe) return -1;
    std::memcpy(bitmap.data() + min_nz, p, n);
    p += n;
  }

  // reverse LUT from bitmap
  std::vector<uint16_t> lut(kBitmapSize, 0);
  int k = 0;
  for (int i = 0; i < kBitmapSize; i++) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = uint16_t(i);
  }
  uint16_t max_value = uint16_t(k - 1);

  if (p + 4 > pe) return -1;
  int32_t huf_len;
  std::memcpy(&huf_len, p, 4);
  p += 4;
  if (huf_len < 20 || p + huf_len > pe) return -1;

  // total u16 words in the block
  int64_t words_per_line = 0;
  for (int c = 0; c < n_channels; c++) words_per_line += int64_t(width) * ch_words[c];
  int64_t total = words_per_line * n_lines;
  if (dst_len < total * 2) return -2;

  // Huffman header: im, iM, tableLength(unused), nBits, room
  const uint8_t* hp = p;
  int32_t im, iM, nbits;
  std::memcpy(&im, hp, 4);
  std::memcpy(&iM, hp + 4, 4);
  std::memcpy(&nbits, hp + 12, 4);
  if (im < 0 || iM >= kHufEncSize || im > iM) return -3;
  hp += 20;

  std::vector<uint64_t> hcode;
  BitReader br(hp, p + huf_len);
  if (!huf_unpack_enc_table(br, im, iM, hcode)) return -3;
  std::vector<DecEntry> dec;
  std::vector<int32_t> long_syms;
  if (!huf_build_dec_table(hcode, im, iM, dec, long_syms)) return -3;

  std::vector<uint16_t> tmp(total);
  if (nbits < 0 || br.p + (int64_t(nbits) + 7) / 8 > p + huf_len) return -3;
  if (!huf_decode(hcode, dec, long_syms, br.p, nbits, iM, tmp.data(), total))
    return -3;

  // per-channel wavelet decode over planes
  int64_t off = 0;
  std::vector<int64_t> plane_off(n_channels);
  for (int c = 0; c < n_channels; c++) {
    plane_off[c] = off;
    int size = ch_words[c];
    for (int j = 0; j < size; j++) {
      wav2_decode(tmp.data() + off + j, width, size, n_lines,
                  width * size, max_value);
    }
    off += int64_t(width) * size * n_lines;
  }

  // reverse LUT
  for (int64_t i = 0; i < total; i++) tmp[i] = lut[tmp[i]];

  // re-interleave planes into scanline order
  uint8_t* d = dst;
  for (int y = 0; y < n_lines; y++) {
    for (int c = 0; c < n_channels; c++) {
      int64_t row_words = int64_t(width) * ch_words[c];
      std::memcpy(d, tmp.data() + plane_off[c] + y * row_words, row_words * 2);
      d += row_words * 2;
    }
  }
  return total * 2;
}

}  // extern "C"
