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
// Bound on this card: the two products (4 * S^2/2 * hd flops per head) on
// the tensor cores. Design (mma.sync.m16n8k16 bf16 -> f32; wgmma with TMA
// and a producer warp would be the card's full rate and is later work):
//   * one block per (query tile of 64 rows, head, batch), 4 warps of 16
//     query rows, a loop over key tiles of 64 up to the causal diagonal and
//     plen: tiles above the diagonal or past plen are never loaded, only
//     the diagonal tile and the tile that holds plen pay for masking;
//   * the model's (B, S, H, hd) layout is read in place; the ragged last
//     tile is zero-filled and masked here, so any S works;
//   * Q, K and V stay bf16 in shared memory, copied by 16-byte cp.async; K/V
//     tiles are double-buffered, the next tile's copy runs under this
//     tile's products. Rows are padded to 272 bytes so every ldmatrix is
//     conflict-free;
//   * a warp keeps its 16 x 128 Q fragments in registers; S = Q K^T takes K
//     fragments by ldmatrix, O += P V takes V fragments by ldmatrix.trans;
//     the score accumulators already have the A-fragment layout of the PV
//     product, so P is packed to bf16 in registers (the rounding the
//     semantics ask for) and never touches shared memory. Row max is a
//     reduction over the 4 lanes of a quad; the row sum stays per lane and
//     is reduced once at the end;
//   * GQA: heads are the middle grid dimension, so the H / KV query heads
//     of one KV head run next to each other and find its K/V tiles in L2;
//     query tiles start longest first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int WARPS = TQ / 16;
constexpr int kThreads = WARPS * 32;
constexpr int LD = HD + 8;               // shared-memory row stride, in bf16
constexpr float kNeg = -1e30f;
constexpr size_t kSmem = sizeof(__nv_bfloat16) * LD * (TQ + 4 * TK);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy; !valid writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// rows [r0, r0 + 64) of a (.., S, heads, HD) tensor -> 64 x HD at dst
// (row stride LD); rows >= S are zero-filled
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t row_stride, int r0, int S) {
  for (int e = threadIdx.x; e < 64 * (HD / 8); e += kThreads) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* p = ok ? src + (size_t)(r0 + r) * row_stride + c : src;
    cp_async16(smem_u32(dst + r * LD + c), p, ok);
  }
}

// grid (ceil(S / TQ), H, B); q/out (B, S, H, HD), k/v (B, S, KV, HD) bf16.
__global__ void __launch_bounds__(kThreads)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const int* __restrict__ plen,
          __nv_bfloat16* __restrict__ out, int S, int H, int KV, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* KVs = Qs + TQ * LD;     // [2 buffers][K, V][TK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pl = min(plen[b], S);
  const int kend = min(min(S, q0 + TQ), pl);
  const int ntiles = (kend + TK - 1) / TK;

  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KV + kvh) * HD;
  const size_t kv_stride = (size_t)KV * HD;

  load_tile(Qs, qb, (size_t)H * HD, q0, S);
  cp_async_commit();
  if (ntiles > 0) {
    load_tile(KVs, kb, kv_stride, 0, S);
    load_tile(KVs + TK * LD, vb, kv_stride, 0, S);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                         // Q landed

  uint32_t qf[HD / 16][4];                 // the warp's 16 x 128 A fragments
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8));

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this lane's two rows

  for (int n = 0; n < ntiles; ++n) {
    const int kt = n * TK;
    if (n + 1 < ntiles) {
      __nv_bfloat16* nb = KVs + ((n + 1) & 1) * 2 * TK * LD;
      load_tile(nb, kb, kv_stride, kt + TK, S);
      load_tile(nb + TK * LD, vb, kv_stride, kt + TK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // tile n landed
    const __nv_bfloat16* Ks = KVs + (n & 1) * 2 * TK * LD;
    const __nv_bfloat16* Vs = Ks + TK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp
    float sacc[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
    const uint32_t k_base = smem_u32(
        Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_base + (np * 16 * LD + kk * 16) * 2);
        mma_bf16(sacc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale, mask (diagonal tile and the tile holding plen only), softmax
    const bool masked = (kt + TK > q0 + 1) || (kt + TK > pl);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[nt][e] * scale;
        if (masked) {
          const int j = kt + nt * 8 + 2 * t + (e & 1);
          const int i = e < 2 ? r0 : r1;
          if (j > i || j >= pl) s = kNeg;
        }
        sacc[nt][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[TK / 16][4];               // P as A fragments, bf16
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sacc[nt][e];
        p[e] = s > 0.5f * kNeg ? __expf(s - (e < 2 ? mn0 : mn1)) : 0.f;
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      oacc[nd][0] *= al0;
      oacc[nd][1] *= al0;
      oacc[nd][2] *= al1;
      oacc[nd][3] *= al1;
    }

    // O += P V: 16 rows x 128 dims per warp
    const uint32_t v_base = smem_u32(
        Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_base + (kk * 16 * LD + dp * 16) * 2);
        mma_bf16(oacc[2 * dp], pa[kk], vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kk], vf[2], vf[3]);
      }
    __syncthreads();                       // tile n consumed by every warp
  }
  cp_async_wait<0>();

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD + 2 * t;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * H * HD + nd * 8) =
          __floats2bfloat162_rn(oacc[nd][0] * inv0, oacc[nd][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * H * HD + nd * 8) =
          __floats2bfloat162_rn(oacc[nd][2] * inv1, oacc[nd][3] * inv1);
  }
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
        flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  flash_fwd<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(plen),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale);
  return (int)cudaGetLastError();
}
