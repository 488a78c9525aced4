// Blosc1-frame decompressor for NanoVDB .nvdb segments.
//
// NanoVDB writes BLOSC-codec files as a sequence of blosc1 frames
// (reference thirdparty/nanovdb/util/IO.h:279-295: blosc_compress_ctx with
// clevel 9, byte shuffle, typesize sizeof(float), LZ4, 256KB blocks). This
// is an independent implementation of the blosc1 container (16-byte header,
// absolute-offset bstarts table, per-split int32 sizes, byte unshuffle)
// with LZ4-block and zlib inner codecs — the two HCR-capable codecs the
// reference tree can emit. blosclz/snappy/zstd frames return an error code
// so the Python layer can report a clear message.
//
// Format semantics established from the public c-blosc 1.x container
// documentation (header layout, split rules: typesize splits when the
// dont-split flag is clear, typesize<=16, blocksize/typesize>=128 and the
// block is not the leftover block).

#include <cstdint>
#include <cstring>

#include <zlib.h>

namespace {

constexpr int kHeaderSize = 16;
constexpr int kMaxSplits = 16;
constexpr int kMinBufferSize = 128;

// flags byte (header[2])
constexpr uint8_t kFlagShuffle = 0x01;
constexpr uint8_t kFlagMemcpyed = 0x02;
constexpr uint8_t kFlagBitShuffle = 0x04;
constexpr uint8_t kFlagDontSplit = 0x10;

inline int32_t read_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/ARM LE)
  return v;
}

// Standard LZ4 block decode. Returns decompressed size or -1.
int64_t lz4_block_decode(const uint8_t* src, int64_t srclen, uint8_t* dst,
                         int64_t dstcap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + srclen;
  uint8_t* op = dst;
  uint8_t* oend = dst + dstcap;
  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match part
    // match
    if (ip + 2 > iend) return -1;
    int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 0x0F);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t* ref = op - offset;
    for (int64_t i = 0; i < mlen; ++i) op[i] = ref[i];  // overlap-safe
    op += mlen;
  }
  return op - dst;
}

// Byte unshuffle: src holds typesize planes of (blocksize/typesize) bytes;
// interleave back to AoS order. Trailing blocksize%typesize bytes copy as-is.
void unshuffle(int typesize, int64_t blocksize, const uint8_t* src,
               uint8_t* dst) {
  int64_t n = blocksize / typesize;
  for (int t = 0; t < typesize; ++t) {
    const uint8_t* plane = src + t * n;
    for (int64_t i = 0; i < n; ++i) dst[i * typesize + t] = plane[i];
  }
  std::memcpy(dst + n * typesize, src + n * typesize, blocksize - n * typesize);
}

}  // namespace

extern "C" {

// Decompress one blosc1 frame. Returns the decompressed byte count, or:
//  -1 malformed frame, -2 destination too small, -3 unsupported inner codec,
//  -4 bitshuffle unsupported, -5 inner codec failure.
int64_t etx_blosc_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                             int64_t dstcap) {
  if (srclen < kHeaderSize) return -1;
  const uint8_t flags = src[2];
  const int typesize = src[3];
  const int64_t nbytes = read_i32(src + 4);
  const int64_t blocksize = read_i32(src + 8);
  const int64_t cbytes = read_i32(src + 12);
  if (nbytes < 0 || blocksize <= 0 || cbytes < kHeaderSize || cbytes > srclen)
    return -1;
  if (nbytes > dstcap) return -2;
  if (nbytes == 0) return 0;
  if (flags & kFlagBitShuffle) return -4;
  const int compcode = flags >> 5;  // 0 blosclz, 1 lz4/lz4hc, 3 zlib...

  if (flags & kFlagMemcpyed) {
    if (kHeaderSize + nbytes > srclen) return -1;
    std::memcpy(dst, src + kHeaderSize, nbytes);
    return nbytes;
  }

  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const int64_t leftover = nbytes % blocksize;
  if (kHeaderSize + nblocks * 4 > srclen) return -1;
  const uint8_t* bstarts = src + kHeaderSize;

  const bool doshuffle = (flags & kFlagShuffle) && typesize > 1;
  uint8_t* tmp = nullptr;
  if (doshuffle) tmp = new uint8_t[blocksize];

  int64_t total = 0;
  for (int64_t j = 0; j < nblocks; ++j) {
    const bool leftoverblock = (j == nblocks - 1) && leftover > 0;
    const int64_t bsize = leftoverblock ? leftover : blocksize;
    uint8_t* out = doshuffle ? tmp : dst + j * blocksize;

    int nsplits = 1;
    if (!(flags & kFlagDontSplit) && typesize <= kMaxSplits && typesize > 0 &&
        blocksize / typesize >= kMinBufferSize && !leftoverblock) {
      nsplits = typesize;
    }
    const int64_t neblock = bsize / nsplits;

    int64_t off = read_i32(bstarts + j * 4);
    uint8_t* part = out;
    for (int s = 0; s < nsplits; ++s) {
      if (off < 0 || off + 4 > srclen) { delete[] tmp; return -1; }
      const int64_t csize = read_i32(src + off);
      off += 4;
      if (csize < 0 || off + csize > srclen) { delete[] tmp; return -1; }
      if (csize == neblock) {
        std::memcpy(part, src + off, neblock);
      } else if (compcode == 1) {  // LZ4 / LZ4HC share the block format
        if (lz4_block_decode(src + off, csize, part, neblock) != neblock) {
          delete[] tmp;
          return -5;
        }
      } else if (compcode == 3) {  // zlib stream
        uLongf outlen = static_cast<uLongf>(neblock);
        if (uncompress(part, &outlen, src + off,
                       static_cast<uLong>(csize)) != Z_OK ||
            static_cast<int64_t>(outlen) != neblock) {
          delete[] tmp;
          return -5;
        }
      } else {
        delete[] tmp;
        return -3;
      }
      off += csize;
      part += neblock;
    }

    if (doshuffle) unshuffle(typesize, bsize, tmp, dst + j * blocksize);
    total += bsize;
  }
  delete[] tmp;
  return total == nbytes ? nbytes : -1;
}

}  // extern "C"
