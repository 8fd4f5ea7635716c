// K1': packed dequant-matmul by the slab-dot route (qfn-b) for Hopper
// (sm_90a): y = s . ((2/maxq) . (bf16(x) . codes^T) - sum(bf16(x))).
//
// Replaces the Pallas kernel scripts/bench_kernel.py (slabdot_matmul ->
// _slabdot_kernel), the microbenchmark's variant of K1. The function is
// K1's for qfn-b; the arithmetic is the variant's own and stays so:
//   * field k of a plane's words becomes a slab of bf16 values 128 + c by
//     shifting the field down, masking it in both half-words and OR-ing
//     0x43004300 (bf16 0x4300 = 128; a code fills the low mantissa bits
//     exactly): one shift and one lop3 per field, no convert;
//   * each slab is dotted against its contiguous x chunk
//     x[:, k.2nw : (k+1).2nw] with f32 accumulation;
//   * the 128 offset leaves once per plane, as -128 . sum(x) in f32, then
//     the plane weights and the qfn-b affine map apply.
// K1 subtracts the offset exactly per element; this variant pays f32 digits
// for it (sums of magnitude 128 . |x| . sqrt(d)), which is why its limit
// against K1 is 2e-2 of max |y| (against its plain version 1e-3: the same
// arithmetic in another summation order).
//
// Bound on this card: the packed planes' bytes (the five 2-bit Llama-2-7B
// shapes: 84 MB, 0.025 ms at 3.35 TB/s). What binds it as it stands
// (tools/tune_slabdot.py, PERF.md): not the copies, which stream about
// twice as fast as the whole kernel, but the consumer warps' unpack (15
// integer operations a 2-bit word) feeding the products: each alone adds
// little to the copies' time, the two together about as much again.
// Design (same plane layout as K1: word (j, i), field k, half h = code of
// output column i at fan-in column k.2nw + 2j + h):
//   * the CODES are the A operand of mma.sync.m16n8k16 (16 output columns by
//     16 fan-in columns) and bf16(x)^T the B operand (16 fan-in columns by 8
//     rows of x). For field k and word rows j0..j0+7, lane (g = lane / 4,
//     t = lane % 4) needs the words (j0 + t, row g), (j0 + t, row g + 8),
//     (j0 + t + 4, ..): one masked word IS one A register (two fan-in
//     columns 2j + h). A warp owns 32 output columns as two m-tiles
//     interleaved by 4 (m-tile q, row r = column 4 (r % 8) + 2q + r / 8), so
//     a lane's four words of a word row are one 16-byte shared-memory read;
//   * the plane words come by TMA: one lane of a producer warp issues ONE
//     2-D tensor copy a stage (cp.async.bulk.tensor through a tensor map of
//     the plane made on the host: a box of RPS = 32 word rows by SROW = 136
//     columns, 17 KB) into a ring of STAGES stages, each guarded by a "full"
//     mbarrier (transaction bytes) and an "empty" one (the consumer warps).
//     The 8 columns past the group's 128 are read for nothing (the next
//     group's, from L2 as a rule) and keep the rows SROW words apart, so the
//     8 lanes of each quarter-warp's 16-byte reads fall into 8 different
//     4-bank groups. (Sixteen 1-D bulk copies of one row a stage moved the
//     words about a tenth slower; 16-row stages and deeper rings were no
//     faster.) The consumer warps only unpack and multiply; no consumer
//     issues a global load of the planes;
//   * a block (the blocks of one cluster) owns tile_m output columns, the
//     argument the microbenchmark sweeps: it walks them 128 columns at a
//     time, both planes of a column group in turn, and the producer runs
//     straight on into the next group, so the first DRAM round trip is paid
//     once a block, not once a group;
//   * ONE launch a call, no scratch, no atomics: the fan-in splits of a
//     column block are the blocks of one thread-block cluster (at most 8),
//     as in dequant_matmul_decode.cu. Each leaves its f32 partials (both
//     planes weighted and added) in its shared memory; after a cluster
//     barrier block `split` adds its share of the outputs over the splits
//     through distributed shared memory in split order (the same bits every
//     run), takes 128 . sum_p pw_p . sum(x) off and applies the qfn-b map.
//     When the partials of B rows x tile_m columns exceed 32 KB, the column
//     groups go in chunks with a barrier pair each; the producer keeps a
//     ring's worth of the next chunk in flight across the barriers;
//   * bf16(x) for the block's split of the fan-in is staged once in shared
//     memory (B rows only; the lanes of rows >= B of the B operand read row
//     B - 1 instead, and their products go to columns of C nobody stores),
//     while the producer's first copies are in flight; word (b, group,
//     field k, pair u) holds the columns k.2nw + 16.group + 2u, +1, rows
//     padded to 4 mod 32 words so the B fragment reads are conflict-free.
// Ragged edges: word rows >= nw and columns >= m arrive as zeros (the
// tensor map's out-of-bounds fill); a zero word unpacks to 128 and meets x
// columns staged as zero past each field's span. Rows past the split's end
// fill whole groups that no warp reads. Rows of x >= B multiply as zero and
// are never stored. tile_m is a multiple of 128 that divides m, so every
// output column is real.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NCW = 4;                 // consumer warps
constexpr int NC = 32 * NCW;           // consumer threads
constexpr int NT = NC + 32;            // and one producer warp
constexpr int CG = 32 * NCW;           // columns of a column group
constexpr int GPS = 4;                 // groups of 8 word rows a stage
constexpr int RPS = 8 * GPS;           // word rows of a stage
constexpr int STAGES = 3;
constexpr int SROW = CG + 8;           // a stage's row stride in words
constexpr int STAGE_WORDS = RPS * SROW;
constexpr int MAXB = 8;
constexpr int kMaxSmem = 220 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of the 2-D tensor map (column c, word row r), global -> shared,
// completing on `bar`'s transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(r)
      : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}


__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// field k (at bit fb k of both half-words) as two bf16 values 128 + c
template <int FB>
__device__ __forceinline__ uint32_t slab(uint32_t w, int k) {
  constexpr uint32_t MASK = ((1u << FB) - 1u) * 0x00010001u;
  return ((w >> (FB * k)) & MASK) | 0x43004300u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// Words per staged row of x for `ng` groups with `fph` fields per half-word:
// 8 words (16 bf16) per group and field, padded to 4 mod 32.
__host__ __device__ inline int row_words(int ng, int fph) {
  const int w = ng * fph * 8;
  return w + ((4 - w % 32) + 32) % 32;
}

// One plane's share of this block: groups [rg0, rg1) of 8 word rows,
// stages of GPS groups.
struct Plane {
  int fb, nw, rg0, rg1, nst;
  float pw;
};
__device__ __forceinline__ Plane plane_of(int fb, float pw, int d, int split,
                                          int splits) {
  Plane p;
  p.fb = fb;
  p.pw = pw;
  p.nw = d * fb / 32;
  const int NG = (p.nw + 7) / 8;
  p.rg0 = (int)((long long)NG * split / splits);
  p.rg1 = (int)((long long)NG * (split + 1) / splits);
  p.nst = (p.rg1 - p.rg0 + GPS - 1) / GPS;
  return p;
}

// bf16(x) rows b0 .. b0 + Bz - 1 of plane `pl`'s split, as described above;
// zero past the field's span. The consumer threads only.
__device__ void stage_x(uint32_t* xs, int RS, const void* xv, bool x_bf16,
                        int Bz, int b0, int d, const Plane& pl, int tid) {
  const int fph = 16 / pl.fb, nw = pl.nw, ng = pl.rg1 - pl.rg0;
  if ((2 * nw) % 8 == 0) {
    // whole 16-byte pieces: each lies inside the span or outside
    const int pieces = ng * fph * 2, total = Bz * pieces;
    for (int e0 = tid; e0 < total; e0 += 4 * NC) {
      uint4 v[4];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {       // four loads in flight
        const int e = e0 + u * NC;
        const int b = e / pieces, pc = e - b * pieces;
        const int k = (pc >> 1) % fph, rgl = (pc >> 1) / fph;
        const int off = 16 * (pl.rg0 + rgl) + 8 * (pc & 1);
        at[u] = e < total ? b * RS + pc * 4 : -1;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && off < 2 * nw) {
          const size_t src = (size_t)(b0 + b) * d + (size_t)k * 2 * nw + off;
          v[u] = x_bf16 ? ld_eight(static_cast<const __nv_bfloat16*>(xv) + src)
                        : ld_eight(static_cast<const float*>(xv) + src);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (at[u] >= 0) *reinterpret_cast<uint4*>(xs + at[u]) = v[u];
    }
  } else {
    const int per_row = ng * fph * 8;
    for (int e = tid; e < Bz * per_row; e += NC) {
      const int b = e / per_row, r = e - b * per_row;
      const int u = r & 7, k = (r >> 3) % fph, rgl = (r >> 3) / fph;
      const int off = 16 * (pl.rg0 + rgl) + 2 * u;
      uint32_t v = 0u;
      if (off < 2 * nw) {
        const size_t src = (size_t)(b0 + b) * d + (size_t)k * 2 * nw + off;
        v = x_bf16 ? ld_pair(static_cast<const __nv_bfloat16*>(xv) + src)
                   : ld_pair(static_cast<const float*>(xv) + src);
      }
      xs[b * RS + r] = v;
    }
  }
}

// The `ngrp` groups (1 to GPS) of one stage of a plane of FB-bit fields.
// `st` points at the lane's words (row t, columns 4g .. 4g + 3 of the
// warp's 32) of the stage's first group, `xr` at its staged x (row g, word
// t) of that group. The products go to four chains of accumulators,
// acc[k % 2][q] for field k and m-tile q (eight, one set per group, were
// measured no faster).
template <int FB>
__device__ __forceinline__ void consume(float (&acc)[2][2][4],
                                        const uint32_t* st, const uint32_t* xr,
                                        int ngrp) {
  constexpr int FPH = 16 / FB;
#pragma unroll
  for (int grp = 0; grp < GPS; ++grp) {
    if (grp >= ngrp) break;
    const uint4 w0 = *reinterpret_cast<const uint4*>(st + 8 * grp * SROW);
    const uint4 w1 =
        *reinterpret_cast<const uint4*>(st + (8 * grp + 4) * SROW);
    const uint32_t* xg = xr + grp * FPH * 8;
#pragma unroll
    for (int k = 0; k < FPH; ++k) {
      const uint32_t b0 = xg[k * 8], b1 = xg[k * 8 + 4];
      mma_bf16(acc[k & 1][0], slab<FB>(w0.x, k), slab<FB>(w0.y, k),
               slab<FB>(w1.x, k), slab<FB>(w1.y, k), b0, b1);
      mma_bf16(acc[k & 1][1], slab<FB>(w0.z, k), slab<FB>(w0.w, k),
               slab<FB>(w1.z, k), slab<FB>(w1.w, k), b0, b1);
    }
  }
}

// grid (m / tile_m, splits, ceil(B / 8)), NT threads, clusters of
// (1, splits, 1). Dynamic shared memory: the ring, then the partials of
// min(B, 8) rows x chunk_cols columns (at the same offset in every block of
// the cluster: the others read it), then the staged x of each plane.
__global__ void __launch_bounds__(NT, 2)
sd_kernel(const void* __restrict__ x, int is_bf16, int B, int d,
          const __grid_constant__ CUtensorMap map0, int fb0,
          const __grid_constant__ CUtensorMap map1, int fb1, int nplanes,
          float pw0, float pw1, int m, int tile_m, int chunk_cols, float maxq,
          const float* __restrict__ scale, void* __restrict__ out) {
  extern __shared__ __align__(128) uint32_t dsmem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float sums[MAXB];     // this split's sum of bf16(x) per row
  __shared__ float xsum[MAXB];     // all splits'
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b0 = blockIdx.z * MAXB, Bz = min(MAXB, B - b0);
  const int rows = min(MAXB, B);
  const int ncg = tile_m / CG, cpc = chunk_cols / CG;
  const int nchunks = (ncg + cpc - 1) / cpc;

  const Plane p0 = plane_of(fb0, pw0, d, split, splits);
  const Plane p1 = plane_of(nplanes > 1 ? fb1 : fb0, pw1, d, split, splits);
  const int spg = p0.nst + (nplanes > 1 ? p1.nst : 0);   // stages a group
  const int total = ncg * spg;
  const size_t col0 = (size_t)cb * tile_m;

  // the boxes land 128-byte aligned (the same offset in every block)
  uint32_t* smem = dsmem + ((128 - (smem_u32(dsmem) & 127)) & 127) / 4;
  uint32_t* ring = smem;
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_WORDS);
  uint32_t* xs0 = smem + STAGES * STAGE_WORDS + rows * chunk_cols;
  const int RS0 = row_words(p0.rg1 - p0.rg0, 16 / p0.fb);
  uint32_t* xs1 = xs0 + rows * RS0;
  const int RS1 = row_words(p1.rg1 - p1.rg0, 16 / p1.fb);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == NCW) {
    // ---- producer: stage L = (column group L / spg, plane, stage) --------
    int L = 0;
    for (int c = 0; c < nchunks; ++c) {
      // this chunk's stages and a ring's worth of the next one: their slots
      // are freed by stages the consumers finish before the barrier
      const int end = min(total, min(ncg, (c + 1) * cpc) * spg + STAGES);
      for (; L < end; ++L) {
        const int cgi = L / spg, r = L - cgi * spg;
        const bool second = r >= p0.nst;
        const Plane pl = second ? p1 : p0;
        const int st = second ? r - p0.nst : r;
        const int slot = L % STAGES, use = L / STAGES;
        if (use > 0) {
          if (lane == 0) mbar_wait(&empty[slot], (use - 1) & 1);
          __syncwarp();
        }
        // one box: RPS word rows from j0 (rows >= nw arrive as zeros) by
        // SROW columns (the group's 128 and 8 more, which keep the rows
        // SROW apart; past m they arrive as zeros)
        if (lane == 0) {
          mbar_expect_tx(&full[slot], STAGE_WORDS * 4);
          tma_load(ring + slot * STAGE_WORDS, second ? &map1 : &map0,
                   (int)col0 + cgi * CG, 8 * (pl.rg0 + GPS * st),
                   &full[slot]);
        }
      }
      __syncwarp();
      cluster.sync();      // the consumers' partials of chunk c are written
      cluster.sync();      // chunk c is reduced: the partials may be reused
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  stage_x(xs0, RS0, x, is_bf16, Bz, b0, d, p0, tid);
  if (nplanes > 1) stage_x(xs1, RS1, x, is_bf16, Bz, b0, d, p1, tid);
  consumers_sync();
  {
    const int per_row = (p0.rg1 - p0.rg0) * (16 / p0.fb) * 8;
    for (int b = warp; b < Bz; b += NCW) {
      float s = 0.f;
      for (int i = lane; i < per_row; i += 32) s += pair_sum(xs0[b * RS0 + i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sums[b] = s;
    }
  }
  // lanes g >= Bz read row Bz - 1: their products land in columns g of C,
  // which no lane stores, so no lane branches around its loads
  const int gx = min(g, Bz - 1);
  const float pwsum = pw0 + (nplanes > 1 ? pw1 : 0.f);
  const float s0 = scale[0], two_q = 2.0f / maxq;
  int L = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int cg0 = c * cpc, cg1 = min(ncg, cg0 + cpc);
    for (int cgi = cg0; cgi < cg1; ++cgi) {
      float tot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int p = 0; p < nplanes; ++p) {
        const Plane pl = p ? p1 : p0;
        const uint32_t* xr = (p ? xs1 + gx * RS1 : xs0 + gx * RS0) + t;
        float acc[2][2][4];
#pragma unroll
        for (int e = 0; e < 16; ++e) (&acc[0][0][0])[e] = 0.f;
        const int fph = 16 / pl.fb;
        for (int st = 0; st < pl.nst; ++st, ++L) {
          const int slot = L % STAGES;
          mbar_wait(&full[slot], (L / STAGES) & 1);
          const uint32_t* sp =
              ring + slot * STAGE_WORDS + t * SROW + 32 * warp + 4 * g;
          const int ngrp = min(GPS, pl.rg1 - pl.rg0 - GPS * st);
          const uint32_t* xg = xr + GPS * st * fph * 8;
          switch (pl.fb) {
            case 1: consume<1>(acc, sp, xg, ngrp); break;
            case 2: consume<2>(acc, sp, xg, ngrp); break;
            default: consume<4>(acc, sp, xg, ngrp); break;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[q][e] += pl.pw * (acc[0][q][e] + acc[1][q][e]);
      }
      // a lane holds, for rows 2t and 2t + 1 of x, the columns 4g .. 4g + 3
      // of its warp's 32: m-tile q gives 4g + 2q (c0, c1) and 4g + 2q + 1
      // (c2, c3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 2 * t + h;
        if (b < Bz)
          *reinterpret_cast<float4*>(red + b * chunk_cols + (cgi - cg0) * CG +
                                     32 * warp + 4 * g) =
              make_float4(tot[0][h], tot[0][2 + h], tot[1][h], tot[1][2 + h]);
      }
    }
    cluster.sync();
    if (c == 0) {
      if (tid < Bz) {
        float s = 0.f;
        for (int y = 0; y < splits; ++y)
          s += *cluster.map_shared_rank(sums + tid, y);
        xsum[tid] = s;
      }
      consumers_sync();
    }
    // split `split` finishes its share of the chunk's Bz x ccols outputs
    const int q4 = (cg1 - cg0) * CG / 4, all = Bz * q4;
    const int e_end = all * (split + 1) / splits;
    for (int e = all * split / splits + tid; e < e_end; e += NC) {
      const int b = e / q4, cc = (e - b * q4) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int y0 = 0; y0 < splits; y0 += 8) {
        float4 pv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)         // eight remote reads in flight
          if (y0 + u < splits)
            pv[u] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(red, y0 + u) + b * chunk_cols + cc);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (y0 + u < splits) {
            v[0] += pv[u].x;
            v[1] += pv[u].y;
            v[2] += pv[u].z;
            v[3] += pv[u].w;
          }
      }
      const float xb = xsum[b], off = 128.f * pwsum * xb;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s0 * (two_q * (v[j] - off) - xb);
      const size_t at = (size_t)(b0 + b) * m + col0 + cg0 * CG + cc;
      if (is_bf16)
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    cluster.sync();
  }
}

bool fb_ok(int fb) { return fb == 1 || fb == 2 || fb == 4; }

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (nw, m) plane of 32-bit words as a 2-D tensor with boxes of SROW
// columns by RPS word rows, out-of-bounds elements zero.
bool plane_map(CUtensorMap* map, const void* plane, int nw, int m) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)nw};
  const cuuint64_t strides[1] = {(cuuint64_t)m * 4};
  const cuuint32_t box[2] = {SROW, RPS};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(plane),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int B, int d, const int* fbs, int nplanes, int splits,
                  int chunk_cols) {
  const int rows = B < MAXB ? B : MAXB;
  size_t s = 128 + (size_t)STAGES * STAGE_WORDS * 4 +
             (size_t)rows * chunk_cols * 4;
  for (int p = 0; p < nplanes; ++p) {
    const int NG = (d * fbs[p] / 32 + 7) / 8;
    s += (size_t)rows * row_words((NG + splits - 1) / splits, 16 / fbs[p]) * 4;
  }
  return s;
}

}  // namespace

// x (B, d) and out (B, m) share one dtype: bf16 (is_bf16 = 1) or f32 (x is
// rounded to bf16 inside either way); x 32-byte aligned. planes: int32
// (d*fb/32, m) each, 16-byte aligned. tile_m: a multiple of 128 that divides
// m. 1 <= splits <= 8 parts of the fan-in (the blocks of one cluster), at
// most the groups of 8 word rows of the shortest plane. chunk_cols: a
// multiple of 128, the columns whose partials one barrier pair reduces.
// scale -> one f32 (device). Returns the CUDA error code (0 = success).
extern "C" int quip_slabdot_matmul(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m,
    int tile_m, int splits, int chunk_cols, float maxq, const void* scale,
    void* out, void* stream) {
  const int fbs[2] = {fb0, fb1};
  if (nplanes < 1 || nplanes > 2 || !fb_ok(fb0) ||
      (nplanes == 2 && !fb_ok(fb1)) || B < 1 || d < 32 || d % 32 != 0 ||
      tile_m < CG || tile_m % CG != 0 || m % tile_m != 0 || splits < 1 ||
      splits > 8 || chunk_cols < CG || chunk_cols % CG != 0)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < nplanes; ++p)
    if (splits > (d * fbs[p] / 32 + 7) / 8) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, d, fbs, nplanes, splits, chunk_cols);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m / tile_m, splits, (B + MAXB - 1) / MAXB);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CUtensorMap map0, map1;
  if (!plane_map(&map0, plane0, d * fb0 / 32, m) ||
      !plane_map(&map1, nplanes > 1 ? plane1 : plane0,
                 d * (nplanes > 1 ? fb1 : fb0) / 32, m))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, sd_kernel, x, is_bf16, B, d, map0, fb0, map1, fb1, nplanes, pw0,
      pw1, m, tile_m, chunk_cols, maxq, static_cast<const float*>(scale), out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
