// K2: causal flash prefill attention for Hopper (sm_90a), hd = 128.
//
// Replaces the Pallas kernel quip_tpu/kernels/flash_attn.py
// (flash_prefill -> _kernel, wrapper flash_prefill_bshd). Same semantics:
// key j is valid for query i iff j <= i and j < plen[b]; GQA head h reads
// KV head h / (H / KV); online softmax with f32 m / l / acc; the weights p
// are rounded to bf16 before the PV product (as the TPU kernel feeds them
// to the MXU) while l sums the unrounded p; output acc / max(l, 1e-30), so
// padded query rows never NaN.
//
// Bound on this card: the two products (4 * S^2/2 * hd flops a head, 989
// TFLOP/s bf16) from about 1500 tokens up, the bytes of q, k, v and out
// below that. The design puts the products on wgmma (the only instruction
// that reaches the full tensor-core rate) and keeps the copies, the
// softmax and the products of the two halves of a tile apart in time:
//   * one block per (query tile of TQ = 128 rows, head, batch row) and
//     three warpgroups. A producer warpgroup gives its registers away
//     (setmaxnreg) and one of its threads issues every copy; two consumer
//     warpgroups of 64 query rows each take the registers;
//   * copies by TMA over 4-D tensor maps of (hd, heads, S, B), so the
//     model's (B, S, H, hd) layout is read in place and rows >= S of a
//     batch row read zeros (not the next row's keys). hd = 128 bf16 is two
//     boxes of 64 columns under the 128-byte swizzle. The Q tile comes
//     once; K and V tiles of TK keys come into a ring of STAGES slots,
//     each with a "full" mbarrier for K and one for V (transaction bytes)
//     and an "empty" one for each that the eight consumer warps arrive on:
//     K is released after Q.K^T, V after P.V;
//   * S = Q.K^T is wgmma m64nTKk16 with both operands in shared memory (K
//     stored key x hd is K-major for it). O += P.V is m64n128k16 with P as
//     the register A operand: the score accumulators, masked,
//     exponentiated (the max taken on the raw scores, then one FFMA and
//     one ex2 a weight, log2(e) folded into the scale) and packed to bf16,
//     are already in the A-fragment layout, so P never touches shared
//     memory; V (key x hd) is the MN-major B operand, read through the
//     descriptor's transpose bit;
//   * the consumers take turns on the tensor cores, ordered by two named
//     barriers: a turn issues Q.K^T of this tile and P.V of the last one
//     as two wgmma groups and hands the turn over, so one warpgroup's
//     softmax runs under the other's products; inside a warpgroup the
//     softmax of the scores runs while its own P.V is still in flight,
//     and the rescale of O and the packing of P wait for it. No register
//     an in-flight wgmma reads or writes is touched (ptxas would
//     serialise every wgmma); the row max and sum are quad shuffles;
//   * tiles above the causal diagonal or past plen are never loaded; only
//     the diagonal tile and the tile that holds plen pay for masking;
//   * grid (heads, batch, query tiles), the longest query tiles first over
//     every head, and the query heads of one KV head next to each other,
//     so that their K/V tiles are found in L2;
//   * the epilogue normalises in registers and stores rows < S.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;
constexpr int TQ = 128;                    // query rows of a block
constexpr int TK = 128;                    // keys of a tile (tools/tune_flash.py)
constexpr int STAGES = 2;                  // K/V tiles in flight
constexpr int NT = 3 * 128;                // producer + two consumer warpgroups
constexpr int BOX = 64;                    // hd columns of a TMA box (128 bytes)
constexpr int Q_BYTES = TQ * HD * 2;
constexpr int KV_BYTES = TK * HD * 2;      // one K or V tile
constexpr int kSmem = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment
constexpr int kTurn = 1;                   // named barriers 1, 2: whose turn
constexpr float kNeg = -1e30f;

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N), A and B K-major bf16
// tiles in shared memory (descriptors da, db); acc = 0 overwrites D. N is
// the key tile (tools/tune_flash.py writes out the other widths it tries).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
// O (64 x 128, f32) += P (64 x 16, bf16, registers) . V (16 x 128, bf16,
// MN-major in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Descriptor of V's 16-key slice at `addr` as the MN-major B operand of
// P.V: rows are keys (128 bytes: 64 of hd under the 128-byte swizzle),
// 8-key groups 1024 bytes apart (stride offset), the second 64 of hd one
// box (TK rows) on (leading offset).
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((TK * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Online softmax of one tile's raw scores for this lane's two rows:
// s[4i + e] is row r0 (e < 2) or r0 + 8 (e >= 2) at key kt + 8i + 2t +
// (e & 1). m is the raw max (scale > 0 keeps the argmax), so each weight
// is one FFMA and one ex2: 2^(s scale_log2 - m scale_log2). The scores
// become the unrounded weights in place; m steps to the new max, l sums
// the weights, al is the max's step. It touches neither O nor P, so it
// runs while P.V of the last tile is in flight.
template <bool MASK>
__device__ __forceinline__ void softmax_scores(
    float (&s)[TK / 2], float (&m)[2], float (&l)[2], float (&al)[2],
    float scale_log2, int kt, int r0, int pl, int t) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < TK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int j = kt + 8 * i + 2 * t + (e & 1);
        if (j > r0 + 8 * (e >> 1) || j >= pl) s[4 * i + e] = kNeg;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  float mneg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    al[r] = ex2((m[r] - mn) * scale_log2);
    m[r] = mn;
    mneg[r] = -mn * scale_log2;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = s[4 * i + e];
      float w = ex2(fmaf(v, scale_log2, mneg[e >> 1]));
      if (MASK && v <= 0.5f * kNeg) w = 0.f;
      s[4 * i + e] = w;
      ps[e >> 1] += w;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + ps[r];
}

// The rest of the step, once P.V of the last tile is done: O rescaled by
// the max's step, P (bf16, the A fragments of P.V) packed from the
// weights.
__device__ __forceinline__ void softmax_finish(const float (&s)[TK / 2],
                                               const float (&al)[2],
                                               float (&o)[HD / 2],
                                               uint32_t (&p)[TK / 16][4]) {
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    p[i >> 1][(i & 1) * 2] = pack_bf16(s[4 * i], s[4 * i + 1]);
    p[i >> 1][(i & 1) * 2 + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    o[4 * i] *= al[0];
    o[4 * i + 1] *= al[0];
    o[4 * i + 2] *= al[1];
    o[4 * i + 3] *= al[1];
  }
}

// The K/V ring: slot s holds K at base + 2 s KV_BYTES and V after it.
struct Ring {
  unsigned char* base;
  uint64_t *full_k, *full_v, *empty_k, *empty_v;
};
// A consumer lane's place: warpgroup c, its rows r0 and r0 + 8, the
// block's first query row q0, plen, and the address of its 64 Q rows.
struct Rows {
  int c, lane, t, r0, q0, pl;
  uint32_t qa;
  float scale_log2;
};

// Turn n of a consumer warpgroup: Q.K^T of tile n (QK) and P.V of tile
// n - 1 (PV) issued as two wgmma groups, the turn handed to the other
// warpgroup; the scores' softmax once Q.K^T is done (P.V left in flight),
// then the rescale of O and the packing of P once P.V is.
template <bool PV, bool QK>
__device__ __forceinline__ void turn(float (&o)[HD / 2], float (&sc)[TK / 2],
                                     uint32_t (&p)[TK / 16][4],
                                     float (&m)[2], float (&l)[2],
                                     const Ring& ring, const Rows& me,
                                     int n) {
  const int s = n % STAGES, sp = (n + STAGES - 1) % STAGES;
  if (QK) mbar_wait(&ring.full_k[s], (n / STAGES) & 1);
  if (PV) mbar_wait(&ring.full_v[sp], ((n - 1) / STAGES) & 1);
  bar_sync(kTurn + me.c, 256);
  wgmma_fence();
  if (QK) {
    const uint32_t kb = smem_u32(ring.base + s * 2 * KV_BYTES);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      // hd slice j: box j / 4, bytes 32 (j % 4) of its rows
      const uint32_t col = 32 * (j & 3);
      wgmma_ss<TK>(sc, desc_sw128(me.qa + (j >> 2) * TQ * 128 + col),
                   desc_sw128(kb + (j >> 2) * TK * 128 + col), j > 0);
    }
  }
  wgmma_commit();
  if (PV) {
    const uint32_t vb = smem_u32(ring.base + sp * 2 * KV_BYTES + KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_pv(o, p[kk], desc_v(vb + kk * 16 * 128));
  }
  wgmma_commit();
  // the other consumer's turn (consumer 1's last turn has no successor)
  if (me.c == 0 || QK) bar_arrive(kTurn + 1 - me.c, 256);
  float al[2] = {1.f, 1.f};
  if (QK) {
    wgmma_wait<1>();
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) pin(sc[e]);
    if (me.lane == 0) mbar_arrive(&ring.empty_k[s]);
    const int kt = n * TK;
    if (kt + TK > me.q0 + 1 || kt + TK > me.pl)
      softmax_scores<true>(sc, m, l, al, me.scale_log2, kt, me.r0, me.pl,
                           me.t);
    else
      softmax_scores<false>(sc, m, l, al, me.scale_log2, kt, me.r0, me.pl,
                            me.t);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) pin(o[e]);
  if (PV && me.lane == 0) mbar_arrive(&ring.empty_v[sp]);
  if (QK) {
    softmax_finish(sc, al, o, p);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(p[kk][e]);
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) pin(o[e]);
  }
}

// grid (H, B, query tiles); q/out (B, S, H, HD), k/v (B, S, KV, HD) bf16
// through 4-D tensor maps (qmap: boxes of 64 x TQ rows; kmap, vmap: 64 x
// TK rows).
__global__ void __launch_bounds__(NT, 1)
flash_fwd(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const int* __restrict__ plen, __nv_bfloat16* __restrict__ out,
          int S, int H, int KV, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t q_full, full_k[STAGES], full_v[STAGES],
      empty_k[STAGES], empty_v[STAGES];
  // [Q: 2 boxes of TQ rows][slot s: K (2 boxes of TK rows), V (likewise)]
  unsigned char* qs = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  unsigned char* ring = qs + Q_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;   // longest tiles first
  const int kvh = h / (H / KV);
  const int pl = min(plen[b], S);
  const int kend = min(min(S, q0 + TQ), pl);
  const int ntiles = kend > 0 ? (kend + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0 || ntiles == 0) return;
    mbar_expect_tx(&q_full, Q_BYTES);
    for (int j = 0; j < 2; ++j)
      tma_load_4d(qs + j * TQ * 128, &qmap, BOX * j, h, q0, b, &q_full);
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % STAGES;
      const uint32_t ph = ((n / STAGES) & 1) ^ 1;
      unsigned char* kt = ring + s * 2 * KV_BYTES;
      mbar_wait(&empty_k[s], ph);
      mbar_expect_tx(&full_k[s], KV_BYTES);
      for (int j = 0; j < 2; ++j)
        tma_load_4d(kt + j * TK * 128, &kmap, BOX * j, kvh, n * TK, b,
                    &full_k[s]);
      mbar_wait(&empty_v[s], ph);
      mbar_expect_tx(&full_v[s], KV_BYTES);
      for (int j = 0; j < 2; ++j)
        tma_load_4d(kt + KV_BYTES + j * TK * 128, &vmap, BOX * j, kvh,
                    n * TK, b, &full_v[s]);
    }
    return;
  }

  // two consumer warpgroups: c owns query rows q0 + 64c .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = (threadIdx.x >> 7) - 1, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * c + 16 * w + g;     // this lane's rows r0, r0 + 8
  float o[HD / 2], sc[TK / 2];
  uint32_t p[TK / 16][4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < TK / 2; ++e) sc[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = 0u;

  if (ntiles > 0) {
    mbar_wait(&q_full, 0);
    if (c == 1) bar_arrive(kTurn, 256);    // consumer 0 goes first
    const Ring ring_of{ring, full_k, full_v, empty_k, empty_v};
    const Rows me{c, lane, t, r0, q0, pl, smem_u32(qs) + c * 64 * 128,
                  scale_log2};
    turn<false, true>(o, sc, p, m, l, ring_of, me, 0);
    for (int n = 1; n < ntiles; ++n)
      turn<true, true>(o, sc, p, m, l, ring_of, me, n);
    turn<true, false>(o, sc, p, m, l, ring_of, me, ntiles);
  }

  // epilogue: out = acc / max(l, 1e-30), rows < S
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + (size_t)row * H * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r],
                                o[4 * i + 2 * r + 1] * inv[r]);
  }
}

// (hd, heads, S, B) bf16 as a 4-D tensor map, boxes of 64 hd x `rows`
// positions under the 128-byte swizzle; out-of-bounds rows read zero.
bool map_4d(CUtensorMap* map, const void* p, int heads, int S, int B,
            int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q/out (B, S, H, hd), k/v (B, S, KV, hd): contiguous bf16, 16-byte
// aligned; plen (B,) int32 on the device. hd must be 128 and H a multiple
// of KV. Returns the CUDA error code (0 = success).
extern "C" int quip_flash_prefill(const void* q, const void* k, const void* v,
                                  const void* plen, void* out, int B, int S,
                                  int H, int KV, int hd, float scale,
                                  void* stream) {
  if (hd != HD || KV < 1 || H % KV != 0 || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap qm, km, vm;
  if (!map_4d(&qm, q, H, S, B, TQ) || !map_4d(&km, k, KV, S, B, TK) ||
      !map_4d(&vm, v, KV, S, B, TK))
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, B, (S + TQ - 1) / TQ);
  flash_fwd<<<grid, NT, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const int*>(plen),
      static_cast<__nv_bfloat16*>(out), S, H, KV,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
