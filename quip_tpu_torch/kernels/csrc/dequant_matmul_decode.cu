// K1-decode: packed dequant-matmul for 1 <= B <= 8 rows on the tensor cores
// of Hopper (sm_90a), the decode GEMV of y = bf16(x) . dequant(planes)^T.
//
// Replaces, for decode-size batches, the Pallas kernel
// quip_tpu/kernels/dequant_matmul.py (_dequant_matmul_local -> _kernel /
// _plane_codes_dot); dequant_matmul_tile.cu takes the batched path and
// the wrapper sends it the shapes that one does not take in chunks of 8
// rows. Same semantics: x rounded to bf16, f32 accumulation, planes as
// pack/format.py lays them out (word (j, i), field k, half h = code of
// output column i at fan-in column k*2nw + 2j + h), plane weights, qfn-b /
// qfn-a fix-ups with the sum of bf16(x).
//
// Bound on this card: the planes' bytes (2-bit Llama-2-7B: 84 MB over the
// five projection shapes, 0.025 ms at 3.35 TB/s). The unpack on the CUDA
// cores, the products and the copies must overlap, and each launch's fixed
// cost must hide under the stream:
//   * the products are wgmma.m64n8k16 with the rows of x as the narrow
//     side: D (64 output columns x 8 rows of x, f32 in registers) += A (64
//     columns x 16 fan-in columns, the unpacked codes in registers) . B (16
//     fan-in columns x 8 rows, bf16(x)^T in shared memory, read through a
//     descriptor). A lane (g = lane / 4, t = lane % 4) of warp w holds A
//     rows 16w + g and 16w + g + 8 at k pairs (2t, 2t+1) and (2t+8, 2t+9):
//     for the slice "field k, word rows j0..j0+7" the field of words
//     (j0 + t, column) and (j0 + t + 4, column). A row r of m-tile mt is
//     output column 32w + 4g + 2mt + r / 8 of the warpgroup's 128, so the
//     four words a lane needs of a word row are one 16-byte read, and
//     its accumulators hold rows 2t, 2t+1 of x at four neighbouring columns.
//     A wgmma.m64n8k16 costs the tensor cores as much as an N = 16 one
//     (tools/wgmma_rate.py): 16 of them a 4 KB group of 2-bit words;
//   * no shift per field: fields leave a word in runs of 7 / FB (3 at 2
//     bits). The word is shifted once per run and a field is masked where
//     it lies, at bit FB r, under the exponent of 2^(7 - FB r) (0x43004300
//     for r = 0, one FB less a run position): one lop3 makes an operand
//     register of two bf16 values 2^(7 - FB r) + c, exact, and the product
//     with bf16(x) is x c + 2^(7 - FB r) x. The block sums x 2^-(FB r) over
//     its fields and the epilogue takes 128 sum_p pw_p (that sum) off once;
//     x is staged as it is;
//   * x is staged once a block (rows < B only; bf16 x by cp.async, every
//     piece in flight at once, a warp's reads contiguous), K-major without
//     swizzle, field by field: the slice (group, field k) is two core
//     matrices of BP rows of 16 bytes (k 0-7, then 8-15), CM bytes apart,
//     BP = B rounded up to a power of two, CM = 16 BP (+ 16 from BP = 2
//     on, against bank conflicts). wgmma reads 8 rows a core matrix: rows
//     >= B read what follows, and their products land in columns of D that
//     nobody stores;
//   * warp-specialised: a block is 256 output columns, two consumer
//     warpgroups and one producer warp that keeps a ring of STAGES slots
//     in flight, each GPS groups of 8 word rows, one TMA box (128 + 8
//     columns by 8 GPS rows: the 8 spare columns keep the rows 136 words
//     apart, so a quarter-warp's 16-byte reads fall into 8 different bank
//     groups) a consumer warpgroup, guarded by a "full" mbarrier
//     (transaction bytes) and an "empty" one (the consumer warps). A
//     consumer warp reads its words of a slot into registers and frees the
//     slot at once;
//   * each consumer warpgroup unpacks a batch of 2 fields into one of
//     NSETS = 2 register sets while the wgmma of the batch before read the
//     other: fence, the batch's 4 wgmma, commit, then wait_group 1 retires
//     the batch before, whose registers the next batch writes (batches of
//     4 fields spill: tools/tune_decode.py). Each plane of a format has
//     accumulators of its own and the format is dispatched once outside
//     the walk: between planes a write to the accumulators, or a runtime
//     loop over the planes, makes ptxas serialise every wgmma (C7515);
//   * ONE launch a call, no scratch: the fan-in splits of a column block
//     are the blocks of one thread-block cluster (at most 8). Each leaves
//     its f32 partials in its shared memory; after a cluster barrier block
//     `split` adds its share of the outputs over the splits through
//     distributed shared memory in split order and applies the fix-up;
//   * programmatic dependent launch: the barriers, the tensor-map prefetch
//     and the first ring slots of planes (weights: nothing earlier writes
//     them) run before griddepcontrol.wait; x's staging and every global
//     store after it. The producer lets the next grid launch once its last
//     plane copy is issued, the consumers once their walk is done.
// What binds it: tools/tune_decode.py's ablation (PERF.md section 6).
// Ragged edges: word rows >= nw and columns >= m_p arrive as zero words;
// x columns past a field's span are staged as zero. A plane whose rows are
// no multiple of 16 bytes (m_p % 4 != 0) has no tensor map: the same kernel
// with RAGGED set fills the ring by 4-byte cp.async copies of its producer
// warp instead, and stores its outputs one by one.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXB = 8;
constexpr int STAGES = 4;               // ring slots
constexpr int GPS = 2;                  // groups of 8 word rows a slot
constexpr int SROW = 136;               // a box row's stride in words
constexpr int BOXW = 8 * GPS * SROW;    // words of one warpgroup's box
constexpr int BOX_BYTES = 4 * BOXW;     // a multiple of 128
constexpr int FPB_MAX = 2;              // fields a batch of products, at most
constexpr int NSETS = 2;                // operand register sets (batches in
                                        // flight + 1)

constexpr int NWG = 2;                  // consumer warpgroups a block
constexpr int NC = 128 * NWG;           // consumer threads
constexpr int NT = NC + 32;             // and one producer warp
constexpr int BN = 128 * NWG;           // output columns of a block

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

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
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

// 4-byte copy global -> shared, zero-filled when !ok (cp.async)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
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
// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
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

// Per row b < B of a staged part: the sum of bf16(x) (s) and of bf16(x)
// 2^-(FB r) (so: the products carry 2^(7 - FB r) times it). One warp a
// row.
__device__ void part_sums(const unsigned char* xs, int bp, const Part& pt,
                          int B, int warp, int nwarps, int lane, float pw,
                          bool want_xsum, float* sums) {
  const int fph = 16 / pt.fb, fg = 7 / pt.fb, J = 2 * pt.ng;
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
      sums[MAXB + b] += pw * so;
    }
  }
}

// One plane of FB-bit fields, groups [0, ng) of the part, from the ring
// into acc (x . (codes + 128 offsets)^T, unweighted). `it` counts the
// ring's slots across planes; ws: this lane's words in slot 0
// (row t, columns 4g .. 4g + 3 of its warp's 32); slot_words: words
// between slots; desc0: the part's staged x (field 0, piece 0); cm16 and
// fstep: a core matrix's and a field's bytes / 16.
template <int FB>
__device__ __forceinline__ void consume_plane(
    float (&acc)[2][4], int ng, int& it, const uint32_t* ws,
    int slot_words, uint64_t* full, uint64_t* empty, uint64_t desc0,
    uint32_t cm16, uint32_t fstep, int lane, uint32_t e128) {
  constexpr int FPH = 16 / FB, FG = 7 / FB;
  uint32_t er[FG];                 // the exponent of 2^(7 - FB r), r < FG
#pragma unroll
  for (int r = 0; r < FG; ++r) er[r] = e128 - (uint32_t)(FB * r) * 0x00800080u;
  // fields a batch and batches a group; the register sets rotate by batch
  // within a slot
  constexpr int FPB = FPH / 2 < FPB_MAX ? FPH / 2 : FPB_MAX;
  constexpr int BPG = FPH / FPB;
  static_assert(GPS * BPG % NSETS == 0, "a slot's batches fill the sets");
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
          wgmma_n8(acc[0], aq[v][0], dv, (uint32_t)(desc0 >> 32));
          wgmma_n8(acc[1], aq[v][1], dv, (uint32_t)(desc0 >> 32));
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
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(acc[mt][e]);
}

// The block's walk over its planes, heavier first, each into its own
// accumulators (a non-wgmma write to accumulators between the planes, or a
// runtime loop over them, makes ptxas serialise every wgmma: C7515), then
// y = sum_p pw_p acc_p. FB1 = 0: one plane.
template <int FB0, int FB1>
__device__ __forceinline__ void walk_planes(
    float (&y)[2][4], const Part (&pt)[2], unsigned char* const (&xs)[2],
    int bp, const uint32_t* ws, int slot_words, uint64_t* full,
    uint64_t* empty, float pw0, float pw1, int lane, uint32_t e128) {
  const uint32_t cm = core_bytes(bp), cm16 = cm >> 4;
  float acc0[2][4] = {}, acc1[2][4] = {};
  int it = 0;
  if (FB1)
    consume_plane<FB1 ? FB1 : 1>(acc1, pt[1].ng, it, ws, slot_words, full,
                                 empty, desc_plain(smem_u32(xs[1]), cm),
                                 cm16, 2 * pt[1].ng * cm16, lane, e128);
  consume_plane<FB0>(acc0, pt[0].ng, it, ws, slot_words, full, empty,
                     desc_plain(smem_u32(xs[0]), cm), cm16,
                     2 * pt[0].ng * cm16, lane, e128);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[mt][e] = FB1 ? pw0 * acc0[mt][e] + pw1 * acc1[mt][e]
                     : pw0 * acc0[mt][e];
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

// Dynamic shared memory (from a 128-byte aligned base): the ring, the
// partials red (MAXB x BN f32), then each distinct field width's staged x
// and 128 bytes that rows >= B of the last core matrix read.
constexpr int RED_OFFSET = STAGES * NWG * BOX_BYTES;
constexpr int X_OFFSET = RED_OFFSET + MAXB * BN * 4;
__host__ __device__ inline int pad_rows(int B) {
  return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
}

// grid (ceil(m_p / BN), splits), launched in clusters of (1, splits, 1):
// the blocks of a cluster are the splits of one column block. x (B, d) and
// out (B, m_p) are bf16 (is_bf16) or f32. wmap0/1: the planes as (nw, m_p)
// words, boxes of 136 columns by 8 rows (RAGGED: unused, the planes'
// pointers are read instead). e128 = 0x43004300, the exponent of 128 in
// both halves (see code_pair).
template <bool RAGGED>
__global__ void __launch_bounds__(NT, 1)
dm_decode(const __grid_constant__ CUtensorMap wmap0,
          const __grid_constant__ CUtensorMap wmap1,
          const uint32_t* __restrict__ plane0,
          const uint32_t* __restrict__ plane1, const void* __restrict__ x,
          int is_bf16, int B, int d, int fb0, int fb1, int nplanes, float pw0,
          float pw1, int m_p, int splits, int qfn_b, float maxq,
          const float* __restrict__ scale, const float* __restrict__ zero,
          void* __restrict__ out, uint32_t e128) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // [b]: sum bf16(x) of this split; [MAXB + b]: sum_p pw_p sum of the
  // staged operands, whose 128-fold is the offset the products carry
  __shared__ float sums[2 * MAXB];
  __shared__ float tot[2 * MAXB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x, split = blockIdx.y;
  unsigned char* base = dsmem + ((128 - (smem_u32(dsmem) & 127)) & 127);
  uint32_t* ring = reinterpret_cast<uint32_t*>(base);
  float* red = reinterpret_cast<float*>(base + RED_OFFSET);
  const int bp = pad_rows(B);
  const Part pt[2] = {part_of(fb0, d, split, splits),
                      part_of(nplanes > 1 ? fb1 : fb0, d, split, splits)};
  // plane 1 shares plane 0's staged x when its fields are as wide
  unsigned char* xs[2];
  xs[0] = base + X_OFFSET;
  xs[1] = nplanes > 1 && fb1 != fb0 ? xs[0] + x_bytes(pt[0].ng, fb0, bp)
                                    : xs[0];

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], RAGGED ? 32 : 1);
      mbar_init(&empty[s], NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * MAXB) sums[tid] = 0.f;
  __syncthreads();

  if (warp == NC / 32) {
    // ---- producer: slot it = group r of plane p, heavier plane first ----
    if (!RAGGED) {
      if (lane == 0) {
        prefetch_tensormap(&wmap0);
        if (nplanes > 1) prefetch_tensormap(&wmap1);
        int it = 0;
        for (int p = nplanes - 1; p >= 0; --p)
          for (int r = 0; r < pt[p].ng; r += GPS, ++it) {
            const int slot = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
            mbar_expect_tx(&full[slot], NWG * BOX_BYTES);
            for (int c = 0; c < NWG; ++c)
              tma_load(ring + (slot * NWG + c) * BOXW, p ? &wmap1 : &wmap0,
                       cb * BN + 128 * c, 8 * (pt[p].rg0 + r),
                       &full[slot]);
          }
      }
    } else {
      int it = 0;
      for (int p = nplanes - 1; p >= 0; --p) {
        const uint32_t* plane = p ? plane1 : plane0;
        for (int r = 0; r < pt[p].ng; r += GPS, ++it) {
          const int slot = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
          for (int e = lane; e < 8 * GPS * BN; e += 32) {
            const int row = e / BN, col = e - row * BN;
            const int j = 8 * (pt[p].rg0 + r) + row, i = cb * BN + col;
            const bool ok = j < pt[p].nw && i < m_p;
            cp_async4(ring + (slot * NWG + col / 128) * BOXW + row * SROW +
                          col % 128,
                      plane + (ok ? (size_t)j * m_p + i : 0), ok);
          }
          cp_async_arrive(&full[slot]);
        }
      }
    }
    __syncwarp();
    grid_dep_launch();
  } else {
    // ---- consumers --------------------------------------------------------
    grid_dep_wait();                     // x and out belong to earlier grids
    const bool two = xs[1] != xs[0];
    const bool async_x =
        x_async(is_bf16, pt[0]) && (!two || x_async(is_bf16, pt[1]));
    if (async_x) {
      stage_issue<NC>(xs[0], bp, x, B, d, pt[0], tid);
      if (two) stage_issue<NC>(xs[1], bp, x, B, d, pt[1], tid);
      cp_async_wait_all();
    } else {
      stage_x<NC>(xs[0], bp, x, is_bf16, B, d, pt[0], tid);
      if (two) stage_x<NC>(xs[1], bp, x, is_bf16, B, d, pt[1], tid);
    }
    fence_proxy_async();                 // wgmma reads what was stored
    consumers_sync(NC);
    for (int p = 0; p < nplanes; ++p)
      part_sums(xs[p], bp, pt[p], B, warp, NC / 32, lane, p ? pw1 : pw0,
                p == 0, sums);

    const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const uint32_t* ws = ring + c * BOXW + t * SROW + 32 * w + 4 * g;
    float y[2][4];
    // the formats of PLANE_SPLITS: 2 / 4 bits, 2 + 1 and 4 + 4
    const int fmt = nplanes > 1 ? 10 * fb0 + fb1 : fb0;
    if (fmt == 2)
      walk_planes<2, 0>(y, pt, xs, bp, ws, NWG * BOXW, full, empty, pw0, pw1,
                        lane, e128);
    else if (fmt == 4)
      walk_planes<4, 0>(y, pt, xs, bp, ws, NWG * BOXW, full, empty, pw0, pw1,
                        lane, e128);
    else if (fmt == 21)
      walk_planes<2, 1>(y, pt, xs, bp, ws, NWG * BOXW, full, empty, pw0, pw1,
                        lane, e128);
    else
      walk_planes<4, 4>(y, pt, xs, bp, ws, NWG * BOXW, full, empty, pw0, pw1,
                        lane, e128);
    grid_dep_launch();
    // a lane holds, for rows 2t and 2t + 1 of x, the columns 4g .. 4g + 3
    // of its warp's 32: m-tile mt gives 4g + 2mt (d0, d1) and 4g + 2mt + 1
    // (d2, d3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 2 * t + h;
      if (b < B)
        *reinterpret_cast<float4*>(red + b * BN + 128 * c + 32 * w +
                                   4 * g) =
            make_float4(y[0][h], y[0][2 + h], y[1][h], y[1][2 + h]);
    }
  }

  // every split's red and sums are written; the blocks of the cluster then
  // read each other's through distributed shared memory, in split order
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync(); else __syncthreads();
  if (tid < 2 * MAXB) {                // the splits' sums, in split order
    float v[8], s = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y)          // eight remote reads in flight
      v[y] = y >= splits ? 0.f
             : splits > 1 ? *cluster.map_shared_rank(sums + tid, y)
                          : sums[tid];
#pragma unroll
    for (int y = 0; y < 8; ++y) s += v[y];
    tot[tid] = s;
  }
  __syncthreads();
  // split `split` finishes its share of the column block's B x BN outputs
  // (the consumer threads: they have waited for the earlier grids)
  const int all = B * (BN / 4);
  const int e_end = all * (split + 1) / splits;
  for (int e = all * split / splits + tid; e < e_end && tid < NC;
       e += NC) {
    const int b = e / (BN / 4), cc = (e - b * (BN / 4)) * 4;
    const int i = cb * BN + cc;
    if (i >= m_p) continue;
    const float4 pv =
        splits > 1 ? split_sum4(cluster, red, b * BN + cc, splits)
                   : *reinterpret_cast<const float4*>(red + b * BN + cc);
    float v[4] = {pv.x, pv.y, pv.z, pv.w};
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

// the plane formats of pack/format.py's PLANE_SPLITS
bool format_ok(int fb0, int fb1, int nplanes) {
  return nplanes == 1 ? fb0 == 2 || fb0 == 4
                      : nplanes == 2 && ((fb0 == 2 && fb1 == 1) ||
                                         (fb0 == 4 && fb1 == 4));
}

// dynamic shared memory of a launch: 128 bytes of alignment slack, the
// ring, the partials, and x's staged parts for the widest split
size_t smem_bytes(int B, int d, int fb0, int fb1, int nplanes, int splits) {
  size_t s = 128 + X_OFFSET + 128;
  for (int p = 0; p < nplanes; ++p) {
    const int fb = p ? fb1 : fb0;
    if (p == 1 && fb1 == fb0) break;
    const int NG = (d * fb / 32 + 7) / 8;
    s += x_bytes((NG + splits - 1) / splits, fb, pad_rows(B));
  }
  return s;
}

// The (nw, m_p) plane of 32-bit words as a 2-D tensor map with boxes of
// SROW columns by 8 GPS word rows, out-of-bounds words zero.
bool plane_map(CUtensorMap* map, const void* plane, int nw, int m_p) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)m_p, (cuuint64_t)nw};
  const cuuint64_t strides[1] = {(cuuint64_t)m_p * 4};
  const cuuint32_t box[2] = {SROW, 8 * GPS};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(plane),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

constexpr int kMaxSmem = 220 * 1024;   // with the static barriers and sums

template <bool RAGGED>
cudaError_t run(const Args& a, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dm_decode<RAGGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem =
      smem_bytes(a.B, a.d, a.fb0, a.fb1, a.nplanes, a.splits);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map0 = {}, map1 = {};
  if (!RAGGED &&
      (!plane_map(&map0, a.plane0, a.d * a.fb0 / 32, a.m_p) ||
       !plane_map(&map1, a.nplanes > 1 ? a.plane1 : a.plane0,
                  a.d * (a.nplanes > 1 ? a.fb1 : a.fb0) / 32, a.m_p)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.m_p + BN - 1) / BN, a.splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, dm_decode<RAGGED>, map0, map1,
                            a.plane0, a.plane1, a.x, a.is_bf16, a.B, a.d,
                            a.fb0, a.fb1, a.nplanes, a.pw0, a.pw1, a.m_p,
                            a.splits, a.qfn_b, a.maxq, a.scale, a.zero, a.out,
                            0x43004300u);
}

}  // namespace

// x (B, d) and out (B, m_p) share one dtype: bf16 (is_bf16 = 1) or f32;
// 1 <= B <= 8; x 32-byte aligned. planes: int32 (d*fb/32, m_p) each, as
// PLANE_SPLITS lays out 2, 3 (2 + 1), 4 and 8 (4 + 4) bits. ragged: 0
// for the TMA ring (m_p % 4 == 0, planes 16-byte aligned), 1 for cp.async
// copies (any m_p). 1 <= splits <= 8 parts of the fan-in (the blocks of one
// cluster), at most the groups of 8 word rows of the shortest plane. qfn-b:
// scale -> one f32 (device); qfn-a: scale, zero -> (m_p,) f32. Returns the
// CUDA error code (0 = success).
extern "C" int quip_dequant_matmul_decode(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m_p,
    int ragged, int splits, int qfn_b, float maxq, const void* scale,
    const void* zero, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!format_ok(fb0, fb1, nplanes)) return (int)cudaErrorInvalidValue;
  if (B < 1 || B > MAXB || splits < 1 || splits > 8 || d % 32 != 0 ||
      (!ragged && m_p % 4 != 0))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < nplanes; ++p)
    if (splits > (d * (p ? fb1 : fb0) / 32 + 7) / 8)
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
  const cudaError_t e = ragged ? run<true>(a, s) : run<false>(a, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
