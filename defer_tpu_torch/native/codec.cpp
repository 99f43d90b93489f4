// Native transfer codec: byteshuffle + zstd (the port's own copy of
// defer_tpu/native/codec.cpp; the same functions, the same output).
//
// The reference compresses every weight and activation hop with
// ZFP + LZ4 (reference src/dispatcher.py:89-92, src/node.py:93-96) —
// a float-aware transform feeding a general-purpose compressor. Here
// the float-aware transform is a byte-plane shuffle (groups
// sign/exponent bytes of consecutive elements, which entropy-codes far
// better than interleaved IEEE754), and the compressor is zstd.
//
// C ABI only — consumed via ctypes.
//
// The four zstd entry points used here are declared below rather than
// taken from <zstd.h>: a host may carry the zstd runtime
// (libzstd.so.1) without its development header, and these signatures
// are zstd's stable ABI.
//
// Build: g++ -O3 -shared -fPIC codec.cpp -o libcodec.so -l:libzstd.so.1

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
}

namespace {

// Scatter element bytes into per-position planes: for elem size k and n
// elements, dst[j*n + i] = src[i*k + j]. Blocked over i for locality.
void byteshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t k) {
  constexpr size_t kBlock = 4096;
  for (size_t i0 = 0; i0 < n; i0 += kBlock) {
    const size_t i1 = i0 + kBlock < n ? i0 + kBlock : n;
    for (size_t j = 0; j < k; ++j) {
      uint8_t* d = dst + j * n;
      const uint8_t* s = src + j;
      for (size_t i = i0; i < i1; ++i) d[i] = s[i * k];
    }
  }
}

void byteunshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t k) {
  constexpr size_t kBlock = 4096;
  for (size_t i0 = 0; i0 < n; i0 += kBlock) {
    const size_t i1 = i0 + kBlock < n ? i0 + kBlock : n;
    for (size_t j = 0; j < k; ++j) {
      const uint8_t* s = src + j * n;
      uint8_t* d = dst + j;
      for (size_t i = i0; i < i1; ++i) d[i * k] = s[i];
    }
  }
}

}  // namespace

extern "C" {

// Upper bound on encode output for nbytes of input.
size_t defer_codec_bound(size_t nbytes) { return ZSTD_compressBound(nbytes); }

// Encode nbytes of src (elem_size-byte elements) into dst.
// Returns compressed size, or 0 on error (dst_cap too small / zstd
// failure). elem_size==1 skips the shuffle.
size_t defer_codec_encode(const uint8_t* src, size_t nbytes, size_t elem_size,
                          int level, uint8_t* dst, size_t dst_cap) {
  const uint8_t* input = src;
  std::vector<uint8_t> shuffled;
  if (elem_size > 1 && nbytes % elem_size == 0) {
    shuffled.resize(nbytes);
    byteshuffle(src, shuffled.data(), nbytes / elem_size, elem_size);
    input = shuffled.data();
  }
  const size_t r = ZSTD_compress(dst, dst_cap, input, nbytes, level);
  return ZSTD_isError(r) ? 0 : r;
}

// Decode into exactly nbytes_out at dst. Returns nbytes_out, or 0 on
// error (corrupt frame / size mismatch).
size_t defer_codec_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                          size_t nbytes_out, size_t elem_size) {
  if (elem_size > 1 && nbytes_out % elem_size == 0) {
    std::vector<uint8_t> shuffled(nbytes_out);
    const size_t r = ZSTD_decompress(shuffled.data(), nbytes_out, src, src_len);
    if (ZSTD_isError(r) || r != nbytes_out) return 0;
    byteunshuffle(shuffled.data(), dst, nbytes_out / elem_size, elem_size);
    return nbytes_out;
  }
  const size_t r = ZSTD_decompress(dst, nbytes_out, src, src_len);
  return (ZSTD_isError(r) || r != nbytes_out) ? 0 : r;
}

}  // extern "C"
