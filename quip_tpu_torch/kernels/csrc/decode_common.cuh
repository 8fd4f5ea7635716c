// Device code shared by the two decode-size dequant-matmuls on wgmma that
// read x themselves and add their fan-in splits through a thread-block
// cluster: dequant_matmul_decode.cu (K1-decode) and slabdot_matmul.cu
// (K1').
//   * bf16 pairs: packing two floats, the sum of a pair; two or eight
//     neighbouring elements of x (bf16 or f32) as bf16 pairs;
//   * the products: wgmma.m64n8k16 with the unpacked codes as the register
//     A operand (64 output columns x 16 fan-in columns) and the rows of x
//     as B (16 fan-in columns x 8 rows, bf16(x)^T in shared memory, read
//     through a descriptor of K-major core matrices without swizzle);
//   * the unpack: a field at bit FB r of both half-words of a word, masked
//     in place under the exponent of 2^(7 - FB r) by one lop3: two bf16
//     values 2^(7 - FB r) + c, exact;
//   * x staged once a block in that core-matrix layout, field by field,
//     and its per-row sums;
//   * the walk of one plane: a consumer warp reads its words of a ring
//     slot into registers, frees the slot, and its warpgroup unpacks a
//     batch of fields into one of two register sets while the wgmma of the
//     batch before read the other; the walk of a format's planes, each into
//     accumulators of its own;
//   * the split-order cluster sum: four neighbouring f32 partials at the
//     same shared-memory offset of every block of the cluster, added in
//     split order (the same bits every run).
// The two kernels differ in the run a shift serves (the template argument
// RUNS): K1-decode shifts a word once per run of 7 / FB fields and masks
// each field where it lies, so its operands carry 2^(7 - FB r) x; K1'
// shifts every field down to bit 0 under 128's exponent (runs of one
// field, the slab-dot route's own unpack), so every operand is 128 + c.
#pragma once

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float pair_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return f.x + f.y;
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

// 16-byte copy global -> shared, L2 only, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// D (64 x 8, f32) += A (64 x 16, bf16, registers) . B (16 x 8, bf16, the
// tile of the descriptor {dlo, dhi}). The descriptor comes as two halves:
// only dlo (the start address) moves from slice to slice, so the walk adds
// 32-bit offsets, not 64-bit ones
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t dlo, uint32_t dhi) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 dd;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "mov.b64 dd, {%8, %10};\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, dd, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(dlo), "r"(1),
        "r"(dhi));
}

// field at bit FB r of both half-words of a run, under the exponent of
// 2^(7 - FB r): two bf16 values 2^(7 - FB r) + c, exact (the field fills
// mantissa bits FB r .. FB r + FB - 1 of a value whose last mantissa bit
// is 2^-(FB r)), as (w_run & MASK << FB r) | er in one lop3. er (the
// exponent in both halves: 0x43004300 for r = 0) comes in a register:
// with both constants as immediates ptxas spends two logic instructions
// an operand register.
template <int FB>
__device__ __forceinline__ uint32_t code_pair(uint32_t w_run, int r,
                                              uint32_t er) {
  constexpr uint32_t MP = ((1u << FB) - 1u) * 0x00010001u;
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(d)
      : "r"(w_run), "r"(MP << (FB * r)), "r"(er));
  return d;
}

// One plane's share of a block: groups [rg0, rg0 + ng) of 8 word rows.
struct Part {
  int fb, nw, rg0, ng;
};
__device__ __forceinline__ Part part_of(int fb, int d, int split, int splits) {
  Part p;
  p.fb = fb;
  p.nw = d * fb / 32;
  const int NG = (p.nw + 7) / 8;
  p.rg0 = (int)((long long)NG * split / splits);
  p.ng = (int)((long long)NG * (split + 1) / splits) - p.rg0;
  return p;
}

// Rows a core matrix of staged x holds: B rounded up to a power of two.
__host__ __device__ inline int pad_rows(int B) {
  return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
}
// Staged x of a part, field-major: the core matrix (field k, piece j) of
// 8 fan-in columns (piece j = 2 group + half of the part) at (k 2ng + j)
// cm bytes, row b at 16 b. cm = 16 bp rounds B up to bp rows (rows >= B of
// a core matrix read the next one's) and, from bp = 2 on, leaves 16 bytes
// more, so that neighbouring pieces' rows fall into other bank groups.
__host__ __device__ inline int core_bytes(int bp) {
  return bp == 1 ? 16 : 16 * bp + 16;
}
__host__ __device__ inline int x_bytes(int ng, int fb, int bp) {
  return (16 / fb) * 2 * ng * core_bytes(bp);
}

// bf16(x) rows < B for part `pt` into xs (the layout above), zero past each
// field's span. The consumer threads only; a warp's neighbouring threads
// take neighbouring pieces of one field of one row (16-byte reads of one
// contiguous span of x). bf16 x in whole pieces (2nw % 8 == 0, the models'
// shapes): stage_issue puts every piece's copy in flight at once
// (cp.async, no registers); stage_x loads through registers otherwise,
// four in flight a thread.
__device__ __forceinline__ bool x_async(bool x_bf16, const Part& pt) {
  return x_bf16 && (2 * pt.nw) % 8 == 0;
}
// piece e of a part: (row b, field k, piece j), j fastest
struct Piece {
  int b, k, off, at;
};
__device__ __forceinline__ Piece piece_of(int e, int bp, const Part& pt) {
  const int fph = 16 / pt.fb, J = 2 * pt.ng;
  Piece q;
  const int j = e % J, rest = e / J;
  q.k = rest % fph;
  q.b = rest / fph;
  q.off = 16 * pt.rg0 + 8 * j;
  q.at = (q.k * J + j) * core_bytes(bp) + 16 * q.b;
  return q;
}
template <int NC>
__device__ void stage_issue(unsigned char* xs, int bp, const void* xv, int B,
                            int d, const Part& pt, int tid) {
  const int two_nw = 2 * pt.nw, total = (16 / pt.fb) * 2 * pt.ng * B;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xv);
  for (int e = tid; e < total; e += NC) {
    const Piece q = piece_of(e, bp, pt);
    const bool in = q.off < two_nw;
    cp_async16(xs + q.at,
               x + (in ? (size_t)q.b * d + (size_t)q.k * two_nw + q.off : 0),
               in);
  }
}
template <int NC>
__device__ void stage_x(unsigned char* xs, int bp, const void* xv,
                        bool x_bf16, int B, int d, const Part& pt, int tid) {
  const int two_nw = 2 * pt.nw, total = (16 / pt.fb) * 2 * pt.ng * B;
  for (int e0 = tid; e0 < total; e0 += 4 * NC) {
    uint4 v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {              // four loads in flight
      const int e = e0 + u * NC;
      const Piece q = piece_of(e, bp, pt);
      at[u] = e < total ? q.at : -1;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e >= total || q.off >= two_nw) continue;
      const size_t src = (size_t)q.b * d + (size_t)q.k * two_nw + q.off;
      if (two_nw % 8 == 0) {       // a piece of 8 lies inside the span
        v[u] = x_bf16 ? ld_eight(static_cast<const __nv_bfloat16*>(xv) + src)
                      : ld_eight(static_cast<const float*>(xv) + src);
      } else {                     // pair by pair
        uint32_t* p = &v[u].x;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (q.off + 2 * c < two_nw)
            p[c] = x_bf16
                       ? ld_pair(static_cast<const __nv_bfloat16*>(xv) + src +
                                 2 * c)
                       : ld_pair(static_cast<const float*>(xv) + src + 2 * c);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) *reinterpret_cast<uint4*>(xs + at[u]) = v[u];
  }
}

// Per row b < B of a staged part: the sum of bf16(x) (into sums[b], when
// want_xsum) and, unless offs is null, pw times the sum of bf16(x)
// 2^-(FB r) over the runs of `fg` fields (added to offs[b]: the products
// carry 2^(7 - FB r) times it). One warp a row.
__device__ void part_sums(const unsigned char* xs, int bp, const Part& pt,
                          int fg, int B, int warp, int nwarps, int lane,
                          float pw, bool want_xsum, float* sums,
                          float* offs) {
  const int fph = 16 / pt.fb, J = 2 * pt.ng;
  for (int b = warp; b < B; b += nwarps) {
    float s = 0.f, so = 0.f;
    for (int i = lane; i < fph * J; i += 32) {  // field i / J, piece i % J
      const uint4 v = *reinterpret_cast<const uint4*>(
          xs + i * core_bytes(bp) + 16 * b);
      const float f = pair_sum(v.x) + pair_sum(v.y) + pair_sum(v.z) +
                      pair_sum(v.w);
      s += f;
      so += f / (float)(1 << (pt.fb * (i / J % fg)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      so += __shfl_xor_sync(0xffffffffu, so, o);
    }
    if (lane == 0) {
      if (want_xsum) sums[b] = s;
      if (offs) offs[b] += pw * so;
    }
  }
}

constexpr int FPB_MAX = 2;              // fields a batch of products, at most
constexpr int NSETS = 2;                // operand register sets (batches in
                                        // flight + 1)

// One plane of FB-bit fields, groups [0, ng) of the part, from a ring of
// STAGES slots (GPS groups of 8 word rows each, rows SROW words apart)
// into acc (x . (codes + offsets)^T, unweighted, in ASETS sets that the
// batches take in turn: with two, a batch's products do not wait for the
// batch before's). RUNS: one shift a run of 7 / FB fields (K1-decode),
// else one a field (K1'). `it` counts the ring's slots across planes and
// calls; ws: this lane's words in slot 0 (row t, columns 4g .. 4g + 3 of
// its warp's 32); slot_words: words between slots; desc0: the part's
// staged x (field 0, piece 0); cm16 and fstep: a core matrix's and a
// field's bytes / 16.
template <int FB, bool RUNS, int STAGES, int GPS, int SROW, int ASETS>
__device__ __forceinline__ void consume_plane(
    float (&acc)[ASETS][2][4], int ng, int& it, const uint32_t* ws,
    int slot_words, uint64_t* full, uint64_t* empty, uint64_t desc0,
    uint32_t cm16, uint32_t fstep, int lane, uint32_t e128) {
  constexpr int FPH = 16 / FB, FG = RUNS ? 7 / FB : 1;
  uint32_t er[FG];                 // the exponent of 2^(7 - FB r), r < FG
#pragma unroll
  for (int r = 0; r < FG; ++r) er[r] = e128 - (uint32_t)(FB * r) * 0x00800080u;
  // fields a batch and batches a group; the register sets rotate by batch
  // within a slot
  constexpr int FPB = FPH / 2 < FPB_MAX ? FPH / 2 : FPB_MAX;
  constexpr int BPG = FPH / FPB;
  static_assert(GPS * BPG % NSETS == 0 && GPS * BPG % ASETS == 0,
                "a slot's batches fill the sets");
  uint32_t a[NSETS][FPB][2][4] = {};
  for (int r0 = 0; r0 < ng; r0 += GPS, ++it) {
    const int slot = it % STAGES;
    mbar_wait(&full[slot], (it / STAGES) & 1);
    const uint32_t* src = ws + slot * slot_words;
    uint32_t wr[GPS][2][4];
#pragma unroll
    for (int gi = 0; gi < GPS; ++gi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            src + (8 * gi + 4 * hh) * SROW);
        wr[gi][hh][0] = v.x;
        wr[gi][hh][1] = v.y;
        wr[gi][hh][2] = v.z;
        wr[gi][hh][3] = v.w;
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);   // the words are in registers
    __syncwarp();
#pragma unroll
    for (int gi = 0; gi < GPS; ++gi) {
      if (GPS > 1 && r0 + gi >= ng) break;
      // slice (group r0 + gi, field k): pieces 2 (r0 + gi), + 1 of field k
      const uint32_t dg = (uint32_t)desc0 + 2 * (r0 + gi) * cm16;
#pragma unroll
      for (int q = 0; q < BPG; ++q) {
        const int bi = gi * BPG + q;     // the batch's place in the slot
        uint32_t(&aq)[FPB][2][4] = a[bi % NSETS];
#pragma unroll
        for (int v = 0; v < FPB; ++v) {
          const int k = q * FPB + v;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                aq[v][mt][2 * hh + h] = code_pair<FB>(
                    wr[gi][hh][2 * mt + h] >> (FB * FG * (k / FG)), k % FG,
                    er[k % FG]);
                pin(aq[v][mt][2 * hh + h]);
              }
        }
        wgmma_fence();
#pragma unroll
        for (int v = 0; v < FPB; ++v) {
          const int k = q * FPB + v;
          const uint32_t dv = dg + (uint32_t)k * fstep;
          wgmma_n8(acc[bi % ASETS][0], aq[v][0], dv, (uint32_t)(desc0 >> 32));
          wgmma_n8(acc[bi % ASETS][1], aq[v][1], dv, (uint32_t)(desc0 >> 32));
        }
        wgmma_commit();
        wgmma_wait<NSETS - 1>();
        // the oldest batch in flight is retired only now: its registers
        // stay its own until here
#pragma unroll
        for (int v = 0; v < FPB; ++v)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) pin(a[(bi + 1) % NSETS][v][mt][e]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < ASETS; ++u)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[u][mt][e]);
}

// A block's walk over its planes, heavier first, each into its own
// accumulators (a non-wgmma write to accumulators between the planes, or a
// runtime loop over them, makes ptxas serialise every wgmma: C7515), then
// y = sum_p pw_p acc_p (a plane's sets added in order). FB1 = 0: one
// plane. The ring and the sets as consume_plane's.
template <int FB0, int FB1, bool RUNS, int STAGES, int GPS, int SROW,
          int ASETS>
__device__ __forceinline__ void walk_planes(
    float (&y)[2][4], const Part (&pt)[2], unsigned char* const (&xs)[2],
    int bp, int& it, const uint32_t* ws, int slot_words, uint64_t* full,
    uint64_t* empty, float pw0, float pw1, int lane, uint32_t e128) {
  const uint32_t cm = core_bytes(bp), cm16 = cm >> 4;
  float acc0[ASETS][2][4] = {}, acc1[ASETS][2][4] = {};
  if (FB1)
    consume_plane<FB1 ? FB1 : 1, RUNS, STAGES, GPS, SROW, ASETS>(
        acc1, pt[1].ng, it, ws, slot_words, full, empty,
        desc_plain(smem_u32(xs[1]), cm), cm16, 2 * pt[1].ng * cm16,
        lane, e128);
  consume_plane<FB0, RUNS, STAGES, GPS, SROW, ASETS>(
      acc0, pt[0].ng, it, ws, slot_words, full, empty,
      desc_plain(smem_u32(xs[0]), cm), cm16, 2 * pt[0].ng * cm16,
      lane, e128);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a0 = acc0[0][mt][e], a1 = acc1[0][mt][e];
#pragma unroll
      for (int u = 1; u < ASETS; ++u) {
        a0 += acc0[u][mt][e];
        a1 += acc1[u][mt][e];
      }
      y[mt][e] = FB1 ? pw0 * a0 + pw1 * a1 : pw0 * a0;
    }
}

// The float4 at red + off in each of the cluster's `splits` blocks, added in
// split order, eight remote reads in flight.
__device__ __forceinline__ float4 split_sum4(
    cooperative_groups::cluster_group& cluster, float* red, int off,
    int splits) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int y0 = 0; y0 < splits; y0 += 8) {
    float4 pv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (y0 + u < splits)
        pv[u] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, y0 + u) + off);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (y0 + u < splits) {
        v.x += pv[u].x;
        v.y += pv[u].y;
        v.z += pv[u].z;
        v.w += pv[u].w;
      }
  }
  return v;
}

}  // namespace
