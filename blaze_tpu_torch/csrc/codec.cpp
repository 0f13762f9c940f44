// Host codec: the marshalling loops between wire bytes and host arrays.
//
// The port's copy of the JAX package's native layer (csrc/codec.cpp, bound
// by blaze_tpu/native/codec.py), itself the analog of the reference's byte
// conversions and NTT bank scatter/gather (blaze/src/utils.rs:117-130,
// blaze/src/ingo_ntt/ntt_data.rs:80-156).  Built with g++ by
// blaze_tpu_torch/_build.py at first use and bound with ctypes by
// blaze_tpu_torch/native/codec.py.  Left out: the blocked (K/T, L, T) u16
// layout (blz_to_blocked / blz_from_blocked), the TPU's tiling workaround.
//
// Wire format: every element is a fixed-width little-endian byte string;
// a limb is 16 bits, held in a uint32 slot.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// n_elems elements of nbytes LE bytes -> n_elems * nbytes/2 uint32 limbs.
void blz_bytes_to_limbs(const uint8_t* src, uint32_t* dst, size_t n_elems, int nbytes) {
  const size_t nl = static_cast<size_t>(nbytes) / 2;
  for (size_t e = 0; e < n_elems; ++e) {
    const uint8_t* s = src + e * nbytes;
    uint32_t* d = dst + e * nl;
    for (size_t i = 0; i < nl; ++i) {
      d[i] = static_cast<uint32_t>(s[2 * i]) | (static_cast<uint32_t>(s[2 * i + 1]) << 8);
    }
  }
}

// uint32 limbs (each < 2^16) -> LE element bytes.
void blz_limbs_to_bytes(const uint32_t* src, uint8_t* dst, size_t n_elems, int nbytes) {
  const size_t nl = static_cast<size_t>(nbytes) / 2;
  for (size_t e = 0; e < n_elems; ++e) {
    const uint32_t* s = src + e * nl;
    uint8_t* d = dst + e * nbytes;
    for (size_t i = 0; i < nl; ++i) {
      d[2 * i] = static_cast<uint8_t>(s[i] & 0xff);
      d[2 * i + 1] = static_cast<uint8_t>((s[i] >> 8) & 0xff);
    }
  }
}

// Strided bank split: element i goes to bank i % nbanks, slot i / nbanks
// (banks laid out one after another).  n_elems must divide by nbanks.
void blz_bank_split(const uint8_t* src, uint8_t* dst, size_t n_elems, int elem_bytes,
                    int nbanks) {
  const size_t per_bank = n_elems / nbanks;
  for (size_t i = 0; i < n_elems; ++i) {
    const size_t bank = i % nbanks, slot = i / nbanks;
    std::memcpy(dst + (bank * per_bank + slot) * elem_bytes, src + i * elem_bytes,
                elem_bytes);
  }
}

// Inverse of blz_bank_split.
void blz_bank_merge(const uint8_t* src, uint8_t* dst, size_t n_elems, int elem_bytes,
                    int nbanks) {
  const size_t per_bank = n_elems / nbanks;
  for (size_t i = 0; i < n_elems; ++i) {
    const size_t bank = i % nbanks, slot = i / nbanks;
    std::memcpy(dst + i * elem_bytes, src + (bank * per_bank + slot) * elem_bytes,
                elem_bytes);
  }
}

// (rows x cols) matrix of elem_bytes elements -> its (cols x rows)
// transpose, in 64 x 64 tiles.
void blz_transpose(const uint8_t* src, uint8_t* dst, size_t rows, size_t cols,
                   int elem_bytes) {
  const size_t kTile = 64;
  for (size_t r0 = 0; r0 < rows; r0 += kTile) {
    for (size_t c0 = 0; c0 < cols; c0 += kTile) {
      const size_t rmax = r0 + kTile < rows ? r0 + kTile : rows;
      const size_t cmax = c0 + kTile < cols ? c0 + kTile : cols;
      for (size_t r = r0; r < rmax; ++r) {
        for (size_t c = c0; c < cmax; ++c) {
          std::memcpy(dst + (c * rows + r) * elem_bytes, src + (r * cols + c) * elem_bytes,
                      elem_bytes);
        }
      }
    }
  }
}

}  // extern "C"
