// Host-side packer of quip_tpu_torch: the port's own copy of quip_tpu's
// native/packlib.cpp, so that an installed package builds without the
// repository's native/ directory.
//
// Multithreaded bit packing and unpacking on the CPU. The port packs on
// the host when a whole model's results stay there (the quantizer's
// --host_offload, then pack_quantized_model), widens 3-bit planes held on
// the CPU and transcodes packed checkpoints to dense ones. The torch-ops
// version of pack/format.py (_pack_plane / _unpack_plane) builds int64
// temporaries a field at a time; this library writes each 32-bit word
// once, rows split over threads.
//
// Layout contract (must match quip_tpu_torch/pack/format.py — the
// halfword-spread transposed planes): a plane is (nwords, m) uint32 with
// nwords = d*bits/32. Word (j, i) holds the code of weight row i, fan-in
// column
//     c = k * (2 * nwords) + 2 * j + h
// in bit-field [16*h + bits*k, 16*h + bits*(k+1)), h in {0,1},
// k in 0..(16/bits)-1. Composite widths (3 = 2+1, 8 = 4+4) are stacks of
// these planes, composed on the Python side (pack/format.py:PLANE_SPLITS).
//
// Beside quip_tpu's three entries (quip_pack, quip_unpack,
// quip_dequant_qfnb, unchanged) the port adds quip_pack_i32 and
// quip_unpack_i32, which read and write int32 codes in place, and
// quip_dequant_table, a grid step by a table the caller computes.
//
// Loaded with ctypes by quip_tpu_torch/pack/native.py and built by
// quip_tpu_torch/kernels/_build.py at first use:
//   g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared
//       -o libpacklib-<hash>.so packlib.cpp -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline bool valid_field_bits(int bits) {
  return bits == 1 || bits == 2 || bits == 4;
}

// Both directions iterate sub-blocks of 64 bytes of codes a column (64
// rows of uint8 codes, 16 of int32) so the large (m, d) code-matrix side
// stays L2-resident per block (64 rows x d<=32k uint8 columns is <=2 MB),
// while the packed side is touched in short contiguous runs of words per
// word-row j.
template <typename T>
constexpr int64_t kRowBlock = 64 / static_cast<int64_t>(sizeof(T));

// One plane from codes of type T: the field of code c is
// (c >> shift) & mask (uint8 codes of one field: shift 0 and every mask
// bit set, as quip_tpu's quip_pack reads them).
template <typename T>
void pack_rowblock(const T* codes, uint32_t* out, int64_t m, int64_t d,
                   int bits, int shift, uint32_t mask, int64_t ib0,
                   int64_t ib1) {
  const int fph = 16 / bits;        // fields per 16-bit half
  const int64_t nw = d / (2 * fph); // words per fan-in row
  for (int64_t b = ib0; b < ib1; b += kRowBlock<T>) {
  const int64_t i0 = b, i1 = std::min<int64_t>(ib1, b + kRowBlock<T>);
  for (int64_t j = 0; j < nw; ++j) {
    uint32_t* orow = out + j * m;
    for (int64_t i = i0; i < i1; ++i) {
      const T* crow = codes + i * d;
      uint32_t w = 0;
      for (int k = 0; k < fph; ++k) {
        const int64_t c = static_cast<int64_t>(k) * 2 * nw + 2 * j;
        w |= ((static_cast<uint32_t>(crow[c]) >> shift) & mask)
             << (bits * k);
        w |= ((static_cast<uint32_t>(crow[c + 1]) >> shift) & mask)
             << (16 + bits * k);
      }
      orow[i] = w;
    }
  }
  }
}

// The fields of one plane, shifted left by `shift`, written into (m, d)
// codes of type T, or OR-ed into them (`accumulate`: the later planes of
// a composite width).
template <typename T>
void unpack_rowblock(const uint32_t* words, T* out, int64_t m, int64_t d,
                     int bits, int shift, bool accumulate, int64_t ib0,
                     int64_t ib1) {
  const int fph = 16 / bits;
  const int64_t nw = d / (2 * fph);
  const uint32_t mask = (1u << bits) - 1u;
  for (int64_t b = ib0; b < ib1; b += kRowBlock<T>) {
  const int64_t i0 = b, i1 = std::min<int64_t>(ib1, b + kRowBlock<T>);
  for (int64_t j = 0; j < nw; ++j) {
    const uint32_t* wrow = words + j * m;
    for (int64_t i = i0; i < i1; ++i) {
      const uint32_t w = wrow[i];
      T* crow = out + i * d;
      for (int k = 0; k < fph; ++k) {
        const int64_t c = static_cast<int64_t>(k) * 2 * nw + 2 * j;
        const T lo = static_cast<T>(((w >> (bits * k)) & mask) << shift);
        const T hi =
            static_cast<T>(((w >> (16 + bits * k)) & mask) << shift);
        crow[c] = accumulate ? static_cast<T>(crow[c] | lo) : lo;
        crow[c + 1] = accumulate ? static_cast<T>(crow[c + 1] | hi) : hi;
      }
    }
  }
  }
}

template <typename Fn>
void parallel_range(int64_t n, int threads, Fn&& fn) {
  if (threads <= 1 || n < 16) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min<int64_t>(n, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back([=, &fn] { fn(r0, r1); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// codes: (m, d) uint8 with values < 2^bits; out: (d*bits/32, m) uint32.
// bits in {1, 2, 4} (field width of one plane). Returns 0 on success.
int quip_pack(const uint8_t* codes, uint32_t* out, int64_t m, int64_t d,
              int bits, int threads) {
  if (!valid_field_bits(bits)) return 1;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  parallel_range(m, threads, [&](int64_t i0, int64_t i1) {
    pack_rowblock(codes, out, m, d, bits, 0, ~0u, i0, i1);
  });
  return 0;
}

int quip_unpack(const uint32_t* words, uint8_t* out, int64_t m, int64_t d,
                int bits, int threads) {
  if (!valid_field_bits(bits)) return 1;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  parallel_range(m, threads, [&](int64_t i0, int64_t i1) {
    unpack_rowblock(words, out, m, d, bits, 0, false, i0, i1);
  });
  return 0;
}

// The port's entries for int32 codes (a quantized layer's codes as the
// quantizer returns them), read and written in place: no uint8 copy, no
// shifted or masked temporary. quip_pack_i32 packs the field
// (code >> shift) & (2^bits - 1) of every code into one plane (a
// composite width calls it once a plane); quip_unpack_i32 writes the
// plane's fields, shifted left by `shift`, into (m, d) int32 codes, or
// ORs them in (`accumulate` nonzero).
int quip_pack_i32(const int32_t* codes, uint32_t* out, int64_t m,
                  int64_t d, int bits, int shift, int threads) {
  if (!valid_field_bits(bits)) return 1;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  if (shift < 0 || shift > 31) return 3;
  const uint32_t mask = (1u << bits) - 1u;
  parallel_range(m, threads, [&](int64_t i0, int64_t i1) {
    pack_rowblock(codes, out, m, d, bits, shift, mask, i0, i1);
  });
  return 0;
}

int quip_unpack_i32(const uint32_t* words, int32_t* out, int64_t m,
                    int64_t d, int bits, int shift, int accumulate,
                    int threads) {
  if (!valid_field_bits(bits)) return 1;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  if (shift < 0 || shift > 31 - bits) return 3;
  parallel_range(m, threads, [&](int64_t i0, int64_t i1) {
    unpack_rowblock(words, out, m, d, bits, shift, accumulate != 0, i0, i1);
  });
  return 0;
}

// Dequantize a single-plane qfn-b matrix straight to float32 (checkpoint
// transcoding: packed -> dense (m, d) without a Python intermediate).
//   w = ((q / maxq) * 2 - 1) * scale,   bits in {2, 4}.
int quip_dequant_qfnb(const uint32_t* words, float* out, int64_t m,
                      int64_t d, int bits, float scale, int threads) {
  if (bits != 2 && bits != 4) return 1;
  const int fph = 16 / bits;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  const int64_t nw = d / cpw;
  const uint32_t mask = (1u << bits) - 1u;
  const float maxq = static_cast<float>((1 << bits) - 1);
  const float a = 2.0f * scale / maxq;
  parallel_range(m, threads, [&](int64_t ib0, int64_t ib1) {
    for (int64_t b = ib0; b < ib1; b += kRowBlock<uint8_t>) {
    const int64_t i0 = b, i1 = std::min<int64_t>(ib1, b + kRowBlock<uint8_t>);
    for (int64_t j = 0; j < nw; ++j) {
      const uint32_t* wrow = words + j * m;
      for (int64_t i = i0; i < i1; ++i) {
        const uint32_t w = wrow[i];
        float* orow = out + i * d;
        for (int k = 0; k < fph; ++k) {
          const int64_t c = static_cast<int64_t>(k) * 2 * nw + 2 * j;
          orow[c] = a * static_cast<float>((w >> (bits * k)) & mask) - scale;
          orow[c + 1] =
              a * static_cast<float>((w >> (16 + bits * k)) & mask) - scale;
        }
      }
    }
    }
  });
  return 0;
}

// The port's grid step: one plane's codes mapped through a table of
// 2^bits floats, out[i, c] = table[code] (bits in {1, 2, 4}). The caller
// computes the table with its own float expression, so every value
// equals, bit for bit, what that expression gives on the unpacked codes
// (quip_tpu_torch's PackedLinear.dequantize builds it with the torch
// expression of its qfn-b grid, widened 3-bit codes included).
int quip_dequant_table(const uint32_t* words, float* out, int64_t m,
                       int64_t d, int bits, const float* table,
                       int threads) {
  if (!valid_field_bits(bits)) return 1;
  const int fph = 16 / bits;
  const int cpw = 32 / bits;
  if (d % cpw != 0) return 2;
  const int64_t nw = d / cpw;
  const uint32_t mask = (1u << bits) - 1u;
  parallel_range(m, threads, [&](int64_t ib0, int64_t ib1) {
    for (int64_t b = ib0; b < ib1; b += kRowBlock<uint8_t>) {
    const int64_t i0 = b, i1 = std::min<int64_t>(ib1, b + kRowBlock<uint8_t>);
    for (int64_t j = 0; j < nw; ++j) {
      const uint32_t* wrow = words + j * m;
      for (int64_t i = i0; i < i1; ++i) {
        const uint32_t w = wrow[i];
        float* orow = out + i * d;
        for (int k = 0; k < fph; ++k) {
          const int64_t c = static_cast<int64_t>(k) * 2 * nw + 2 * j;
          orow[c] = table[(w >> (bits * k)) & mask];
          orow[c + 1] = table[(w >> (16 + bits * k)) & mask];
        }
      }
    }
    }
  });
  return 0;
}

}  // extern "C"
