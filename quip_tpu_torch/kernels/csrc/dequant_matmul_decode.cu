// K1-decode: packed dequant-matmul for 1 <= B <= 8 rows on the tensor cores
// of Hopper (sm_90a), the decode GEMV of y = bf16(x) . dequant(planes)^T.
//
// Replaces, for decode-size batches, the Pallas kernel
// quip_tpu/kernels/dequant_matmul.py (_dequant_matmul_local -> _kernel /
// _plane_codes_dot); dequant_matmul_tile.cu takes the batched path and
// the wrapper sends it the shapes that one does not take in chunks of 8 rows.
// Same
// semantics: x rounded to bf16, f32 accumulation, planes as pack/format.py
// lays them out (word (j, i), field k, half h = code of output column i at
// fan-in column k*2nw + 2j + h), plane weights, qfn-b / qfn-a fix-ups with
// the sum of bf16(x).
//
// Bound on this card: the planes' bytes (2-bit Llama-2-7B: 84 MB over the
// five projection shapes, 0.025 ms at 3.35 TB/s). A kernel that unpacks on
// the CUDA cores is bound by instruction issue at several times that (the
// integer pipe issues a warp's shift or logic instruction every other
// cycle), so the work issued per plane byte is the design constraint:
//   * the CODES are the A operand of mma.sync.m16n8k16 (16 output columns by
//     16 fan-in columns) and x^T the B operand (16 fan-in columns by 8 rows of
//     x): no padded rows of x are multiplied, and one mma consumes 256 codes.
//     For the slice "field k, word rows j0..j0+7, both halves" lane (g =
//     lane / 4, t = lane % 4) needs A[g][2t, 2t+1], A[g+8][2t, 2t+1],
//     A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9]: field k of the words (j0 + t,
//     column of row g), (j0 + t, column of row g+8), (j0 + t + 4, ..). The B
//     fragment is x[g][base + 2t, +1] and x[g][base + 2t + 8, +9], zero for
//     g >= B;
//   * no shift per field: fields leave a word in runs of 7 / FB (3 at 2 bits).
//     The word is shifted once per run and a field is masked where it lies,
//     under the exponent of 128: (w_run & MASK << FB r) | 0x43004300 is one
//     operand register holding two bf16 values 128 + c 2^(FB r), one logic
//     instruction. The x columns of that field are staged times 2^-(FB r)
//     (exact in bf16), so the product is x c + 128 x 2^-(FB r); the offset is
//     not subtracted per register: the block sums its staged operands, and
//     the epilogue takes 128 sum_p pw_p (that sum) off once (exact operands,
//     f32 sums; c <= 15). At 2 bits that is 10 integer operations a word
//     (8 masks, 2 shifts) where a shift and a mask per field were 16;
//   * a warp owns 32 output columns as two m-tiles interleaved by 4 (m-tile
//     q, row r = column 4 (r % 8) + 2q + r / 8), so the four words a lane
//     needs of one word row are one 16-byte load straight from device memory
//     into registers (a warp's load covers four full 128-byte lines), and a
//     lane's four outputs of a row of x are contiguous. The unpacked W and
//     the words never touch shared memory. Per group of 8 word rows and 32
//     columns (1 KB of plane) a warp issues, at 2 bits: 2 loads, 16
//     shared-memory loads of x (conflict-free), 16 mma in two dependent
//     chains per m-tile, and 80 integer operations;
//   * a block is 4 warps (128 columns; 8 warps from 4 rows of x on) over one
//     split of the fan-in, each warp keeping 4 groups (4 KB) in flight in
//     registers (a cp.async ring of 8 or 16 groups in shared memory was
//     slower: more loads in flight lower the memory's rate here); the block
//     stages the bf16(x) columns of its split once (B rows only, 16-byte
//     loads, four in flight), after its first plane loads are under way;
//   * ONE launch a call and no scratch: the splits of a column block are the
//     blocks of one thread-block cluster (at most 8). Each leaves its f32
//     partials in its shared memory, and after a cluster barrier block `split`
//     adds its share of the outputs over the splits through distributed
//     shared memory, in split order (the same order every run), and applies
//     the fix-up.
// What binds it as it stands (tools/tune_decode.py): see PERF.md; the loads
// alone take two thirds of its time, a fixed 5 to 6 us a launch among them.
// Ragged edges: word rows >= nw and columns >= m_p load as zero words, x
// columns past a field's span and rows >= B are zero. Any m_p: when it is no
// multiple of 4 the words are loaded and the outputs stored one by one.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DEPTH = 4;         // groups of 8 word rows in flight per warp
constexpr int MAXB = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// Fields come out of a word in runs of FG = 7 / FB: the word is shifted once
// per run, and field r of the run is masked where it lies, at bit FB r of
// both half-words, under the exponent of 128: two bf16 values 128 + c 2^(FB r).
// The x operand of that field is staged scaled by 2^-(FB r) (exact).
template <int FB>
struct Fields {
  static constexpr int FPH = 16 / FB;
  static constexpr int FG = 7 / FB;
  __host__ __device__ static constexpr int in_run(int k) { return k % FG; }
  // 2^-(FB in_run(k)) as a bf16 pair
  __device__ static uint32_t scale_bits(int k) {
    const uint32_t h = (uint32_t)(127 - FB * in_run(k)) << 7;
    return h | (h << 16);
  }
};
template <int FB>
__device__ __forceinline__ uint32_t code_pair(uint32_t w_run, int r) {
  constexpr uint32_t MP = ((1u << FB) - 1u) * 0x00010001u;
  return (w_run & (MP << (FB * r))) | 0x43004300u;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// 8 neighbouring elements as four bf16 pairs (p is 16-byte aligned for bf16,
// 32-byte for f32)
__device__ __forceinline__ uint4 ld_eight(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 ld_eight(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ float pair_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return f.x + f.y;
}

// Words of shared memory per row of x for `ng` groups of a plane with `fph`
// fields per half-word: 8 words (16 bf16) per group and field, padded to
// 4 mod 32 so that the fragment reads of a warp (word g RS + t, then + 4)
// fall into 32 different banks.
__host__ __device__ inline int row_words(int ng, int fph) {
  const int w = ng * fph * 8;
  return w + ((4 - w % 32) + 32) % 32;
}

// One plane of FB-bit fields: groups [NG split / splits, NG (split + 1) /
// splits) of its word rows, accumulated into acc (codes + 128 offsets,
// unweighted). sums (when not null) gets per row of x the sum of the staged
// bf16(x) at [b] and adds pw times the sum of the scaled operands at
// [MAXB + b].
template <int FB, int NWARP>
__device__ __forceinline__ void run_plane(
    float (&acc)[2][4], const void* __restrict__ xv, bool x_bf16, int B, int d,
    const uint32_t* __restrict__ plane, int m_p, int col0, int split,
    int splits, uint32_t* xs, float* sums, bool want_xsum, float pw) {
  using F = Fields<FB>;
  constexpr int FPH = F::FPH;
  constexpr int NT = 32 * NWARP;
  const int nw = d * FB / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NG = (nw + 7) / 8;
  const int rg0 = (int)((long long)NG * split / splits);
  const int rg1 = (int)((long long)NG * (split + 1) / splits);
  const int ng = rg1 - rg0;
  const int RS = row_words(ng, FPH);
  const int col = col0 + 4 * g;

  uint4 w[DEPTH][2];
  auto load = [&](uint4 (&dst)[2], int rg) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 8 * rg + t + 4 * hh;
      dst[hh] = make_uint4(0u, 0u, 0u, 0u);
      if (rg >= rg1 || j >= nw || col >= m_p) continue;
      const uint32_t* src = plane + (size_t)j * m_p + col;
      if (m_p % 4 == 0) {       // the four words are aligned and inside
        dst[hh] = __ldcs(reinterpret_cast<const uint4*>(src));
      } else {                  // any m_p: word by word
        dst[hh].x = __ldcs(src);
        if (col + 1 < m_p) dst[hh].y = __ldcs(src + 1);
        if (col + 2 < m_p) dst[hh].z = __ldcs(src + 2);
        if (col + 3 < m_p) dst[hh].w = __ldcs(src + 3);
      }
    }
  };
#pragma unroll
  for (int u = 0; u < DEPTH; ++u) load(w[u], rg0 + u);

  // stage bf16(x) 2^-(FB in_run(k)): word (b, group rgl, field k, pair u) at
  // b RS + (rgl FPH + k) 8 + u holds the columns k 2nw + 16 (rg0 + rgl) +
  // 2u, +1; zero past the field's span
  __syncthreads();              // the plane before is done with xs
  const int per_row = ng * FPH * 8;
  if ((2 * nw) % 8 == 0) {
    // whole 16-byte pieces: each lies inside the span or outside
    const int pieces = ng * FPH * 2, total = B * pieces;
    for (int e0 = tid; e0 < total; e0 += 4 * NT) {
      uint4 v[4];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {       // four loads in flight
        const int e = e0 + u * NT;
        const int b = e / pieces, pc = e - b * pieces;
        const int k = (pc >> 1) % FPH, rgl = (pc >> 1) / FPH;
        const int off = 16 * (rg0 + rgl) + 8 * (pc & 1);
        at[u] = e < total ? b * RS + pc * 4 : -1;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && off < 2 * nw) {
          const size_t at = (size_t)b * d + (size_t)k * 2 * nw + off;
          v[u] = x_bf16 ? ld_eight(static_cast<const __nv_bfloat16*>(xv) + at)
                        : ld_eight(static_cast<const float*>(xv) + at);
          const uint32_t sc = F::scale_bits(k);
          v[u].x = mul_bf16x2(v[u].x, sc);
          v[u].y = mul_bf16x2(v[u].y, sc);
          v[u].z = mul_bf16x2(v[u].z, sc);
          v[u].w = mul_bf16x2(v[u].w, sc);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (at[u] >= 0) *reinterpret_cast<uint4*>(xs + at[u]) = v[u];
    }
  } else {
    for (int e = tid; e < B * per_row; e += NT) {
      const int b = e / per_row, r = e - b * per_row;
      const int u = r & 7, k = (r >> 3) % FPH, rgl = (r >> 3) / FPH;
      const int off = 16 * (rg0 + rgl) + 2 * u;
      uint32_t v = 0u;
      if (off < 2 * nw) {
        const size_t at = (size_t)b * d + (size_t)k * 2 * nw + off;
        v = mul_bf16x2(
            x_bf16 ? ld_pair(static_cast<const __nv_bfloat16*>(xv) + at)
                   : ld_pair(static_cast<const float*>(xv) + at),
            F::scale_bits(k));
      }
      xs[b * RS + r] = v;
    }
  }
  __syncthreads();
  if (sums != nullptr) {
    for (int b = warp; b < B; b += NWARP) {
      float s = 0.f, so = 0.f;
      for (int i = lane; i < per_row; i += 32) {
        const float v = pair_sum(xs[b * RS + i]);
        so += v;
        s += v * (float)(1 << (FB * F::in_run((i >> 3) % FPH)));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        so += __shfl_xor_sync(0xffffffffu, so, o);
      }
      if (lane == 0) {
        if (want_xsum) sums[b] = s;
        sums[MAXB + b] += pw * so;
      }
    }
  }

  // odd fields go to a second pair of accumulators: two dependent chains
  // of products per m-tile instead of one
  float odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const uint32_t* xrow = xs + g * RS + t;
  auto compute = [&](const uint4 (&ww)[2], int rgl) {
    const uint32_t wr[2][4] = {{ww[0].x, ww[0].y, ww[0].z, ww[0].w},
                               {ww[1].x, ww[1].y, ww[1].z, ww[1].w}};
#pragma unroll
    for (int run = 0; run * F::FG < FPH; ++run) {
      uint32_t ws[2][4];                  // the run's fields at bit 0
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 4; ++c) ws[hh][c] = wr[hh][c] >> (FB * F::FG * run);
#pragma unroll
      for (int r = 0; r < F::FG; ++r) {
        const int k = run * F::FG + r;
        if (k >= FPH) break;
        uint32_t b0 = 0u, b1 = 0u;
        if (g < B) {
          b0 = xrow[(rgl * FPH + k) * 8];
          b1 = xrow[(rgl * FPH + k) * 8 + 4];
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mma_bf16((k & 1) ? odd[q] : acc[q], code_pair<FB>(ws[0][2 * q], r),
                   code_pair<FB>(ws[0][2 * q + 1], r),
                   code_pair<FB>(ws[1][2 * q], r),
                   code_pair<FB>(ws[1][2 * q + 1], r), b0, b1);
      }
    }
  };
  for (int rb = rg0; rb < rg1; rb += DEPTH) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (rb + u < rg1) compute(w[u], rb + u - rg0);
      load(w[u], rb + u + DEPTH);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] += odd[q][e];
}

__device__ __forceinline__ float fixup(float ycodes, float xsum, int i,
                                       int qfn_b, float maxq,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ zero) {
  if (qfn_b) return scale[0] * ((2.0f / maxq) * ycodes - xsum);
  return scale[i] * ycodes - scale[i] * zero[i] * xsum;
}

// four neighbouring outputs; `n` of them exist, and p is aligned when n == 4
// and m_p % 4 == 0 (`wide`)
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n,
                                       bool wide) {
  if (wide) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = v[j];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4],
                                       int n, bool wide) {
  if (wide) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = __float2bfloat16_rn(v[j]);
}

// grid (ceil(m_p / BN), splits), BN = 32 NWARP, launched in clusters of
// (1, splits, 1): the blocks of a cluster are the splits of one column block.
// x (B, d) and out (B, m_p) are bf16 (is_bf16) or f32.
template <int NWARP>
__global__ void __launch_bounds__(32 * NWARP, 512 / (32 * NWARP))
dm_decode(const void* __restrict__ x, int is_bf16, int B, int d,
          const uint32_t* __restrict__ plane0, int fb0,
          const uint32_t* __restrict__ plane1, int fb1, int nplanes, float pw0,
          float pw1, int m_p, int splits, int qfn_b, float maxq,
          const float* __restrict__ scale, const float* __restrict__ zero,
          void* __restrict__ out) {
  constexpr int NT = 32 * NWARP, BN = 32 * NWARP;
  extern __shared__ __align__(16) uint32_t xs[];
  // [b]: sum bf16(x); [MAXB + b]: sum_p pw_p sum of the scaled operands,
  // whose 128-fold is the offset the products carry
  __shared__ float sums[2 * MAXB];
  __shared__ float tot[2 * MAXB];
  __shared__ __align__(16) float red[MAXB * BN];   // this split's (b, column)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cb = blockIdx.x, split = blockIdx.y;
  const int col0 = cb * BN + warp * 32;

  if (tid < 2 * MAXB) sums[tid] = 0.f;   // run_plane's barriers order this
  float acc[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int p = nplanes - 1; p >= 0; --p) {
    const uint32_t* plane = p ? plane1 : plane0;
    const float pw = p ? pw1 : pw0;
    switch (p ? fb1 : fb0) {
      case 1:
        run_plane<1, NWARP>(acc, x, is_bf16, B, d, plane, m_p, col0, split,
                            splits, xs, sums, p == 0, pw);
        break;
      case 2:
        run_plane<2, NWARP>(acc, x, is_bf16, B, d, plane, m_p, col0, split,
                            splits, xs, sums, p == 0, pw);
        break;
      default:
        run_plane<4, NWARP>(acc, x, is_bf16, B, d, plane, m_p, col0, split,
                            splits, xs, sums, p == 0, pw);
        break;
    }
    // sum_p pw_p S_p = pw0 (S0 + (pw1 / pw0) S1)
    const float f = p ? pw1 / pw0 : pw0;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] *= f;
  }

  // a lane holds, for rows 2t and 2t + 1 of x, the columns 4g .. 4g + 3 of
  // its warp's 32: m-tile q gives 4g + 2q (c0, c1) and 4g + 2q + 1 (c2, c3)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = 2 * t + h;
    if (b < B)
      *reinterpret_cast<float4*>(red + b * BN + warp * 32 + 4 * g) =
          make_float4(acc[0][h], acc[0][2 + h], acc[1][h], acc[1][2 + h]);
  }
  // every split's red and sums are written; the blocks of the cluster then
  // read each other's through distributed shared memory, in split order
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync(); else __syncthreads();
  if (tid < 2 * MAXB) {
    float s = 0.f;
    for (int y = 0; y < splits; ++y)
      s += splits > 1 ? *cluster.map_shared_rank(sums + tid, y) : sums[tid];
    tot[tid] = s;
  }
  __syncthreads();
  // split `split` finishes its share of the column block's B x BN outputs
  const int all = B * (BN / 4);
  const int e_begin = all * split / splits, e_end = all * (split + 1) / splits;
  for (int e = e_begin + tid; e < e_end; e += NT) {
    const int b = e / (BN / 4), c = (e - b * (BN / 4)) * 4;
    const int i = cb * BN + c;
    if (i >= m_p) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int y0 = 0; y0 < splits; y0 += 8) {
      float4 pv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)       // eight remote reads in flight
        if (y0 + u < splits)
          pv[u] = *reinterpret_cast<const float4*>(
              (splits > 1 ? cluster.map_shared_rank(red, y0 + u) : red) +
              b * BN + c);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (y0 + u < splits) {
          v[0] += pv[u].x;
          v[1] += pv[u].y;
          v[2] += pv[u].z;
          v[3] += pv[u].w;
        }
    }
    const float xsum = tot[b], off = 128.f * tot[MAXB + b];
    const int n = min(4, m_p - i);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n)
        v[j] = fixup(v[j] - off, xsum, i + j, qfn_b, maxq, scale, zero);
    const size_t at = (size_t)b * m_p + i;
    if (is_bf16)
      store4(static_cast<__nv_bfloat16*>(out) + at, v, n, m_p % 4 == 0);
    else
      store4(static_cast<float*>(out) + at, v, n, m_p % 4 == 0);
  }
  if (splits > 1) cluster.sync();      // nobody leaves while it is still read
}

bool fb_ok(int fb) { return fb == 1 || fb == 2 || fb == 4; }

// shared-memory bytes for the widest split of either plane
size_t smem_bytes(int B, int d, int fb0, int fb1, int nplanes, int splits) {
  size_t most = 0;
  for (int p = 0; p < nplanes; ++p) {
    const int fb = p ? fb1 : fb0;
    const int NG = (d * fb / 32 + 7) / 8;
    const int ng = (NG + splits - 1) / splits;
    const size_t s = (size_t)B * row_words(ng, 16 / fb) * 4;
    most = s > most ? s : most;
  }
  return most;
}

struct Args {
  const void* x;
  void* out;
  int is_bf16, B, d;
  const uint32_t *plane0, *plane1;
  int fb0, fb1, nplanes;
  float pw0, pw1;
  int m_p, splits;
  int qfn_b;
  float maxq;
  const float *scale, *zero;
};

template <int NWARP>
cudaError_t run(const Args& a, cudaStream_t s) {
  constexpr int kMaxSmem = 160 * 1024;
  constexpr int BN = 32 * NWARP;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dm_decode<NWARP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = smem_bytes(a.B, a.d, a.fb0, a.fb1, a.nplanes, a.splits);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.m_p + BN - 1) / BN, a.splits);
  cfg.blockDim = dim3(32 * NWARP);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dm_decode<NWARP>, a.x, a.is_bf16, a.B, a.d,
                            a.plane0,
                            a.fb0, a.plane1, a.fb1, a.nplanes, a.pw0, a.pw1,
                            a.m_p, a.splits, a.qfn_b, a.maxq, a.scale, a.zero,
                            a.out);
}

}  // namespace

// x (B, d) and out (B, m_p) share one dtype: bf16 (is_bf16 = 1) or f32;
// 1 <= B <= 8. planes: int32 (d*fb/32, m_p) each. nwarps in
// {4, 8}: a block owns 32 nwarps columns. 1 <= splits <= 8 parts of the
// fan-in (the blocks of one cluster), at most the groups of 8 word rows of
// the shortest plane. qfn-b: scale -> one f32 (device); qfn-a: scale, zero ->
// (m_p,) f32. Returns the CUDA error code (0 = success).
extern "C" int quip_dequant_matmul_decode(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m_p,
    int nwarps, int splits, int qfn_b, float maxq, const void* scale,
    const void* zero, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > 2 || !fb_ok(fb0) || (nplanes == 2 && !fb_ok(fb1)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || B > MAXB || splits < 1 || splits > 8 || d % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.out = out;
  a.is_bf16 = is_bf16;
  a.B = B;
  a.d = d;
  a.plane0 = static_cast<const uint32_t*>(plane0);
  a.plane1 = static_cast<const uint32_t*>(plane1);
  a.fb0 = fb0;
  a.fb1 = fb1;
  a.nplanes = nplanes;
  a.pw0 = pw0;
  a.pw1 = pw1;
  a.m_p = m_p;
  a.splits = splits;
  a.qfn_b = qfn_b;
  a.maxq = maxq;
  a.scale = static_cast<const float*>(scale);
  a.zero = static_cast<const float*>(zero);
  if (nwarps == 4) return (int)run<4>(a, s);
  if (nwarps == 8) return (int)run<8>(a, s);
  return (int)cudaErrorInvalidValue;
}
