// K2: causal flash prefill attention for Hopper (sm_90a), hd = 128.
//
// Replaces the Pallas kernel quip_tpu/kernels/flash_attn.py
// (flash_prefill -> _kernel, wrapper flash_prefill_bshd). Same semantics:
// key j is valid for query i iff j <= i and j < plen[b]; GQA head h reads
// KV head h / (H / KV); online softmax with f32 m / l / acc; the weights p
// are rounded to bf16 before the PV product (as the TPU kernel feeds them
// to the MXU); output acc / max(l, 1e-30), so padded query rows never NaN.
//
// Bound on this card: the two products (4 * S^2/2 * hd flops per head) and,
// at S of a few hundred, the per-tile softmax bookkeeping. This first
// version runs them on the CUDA cores in f32 (mma.sync / wgmma, TMA and
// warp specialisation are later work). Design:
//   * one block per (query tile of 64 rows, head, batch); 8 warps of 8 query
//     rows; a loop over key tiles of 32 up to the causal diagonal and plen
//     (tiles above the diagonal are never read);
//   * the model's (B, S, H, hd) layout is read in place, no transposes and
//     no 256-padding: the ragged last tile is masked here;
//   * Q (64 x 128) and each K / V tile are staged once in shared memory as
//     f32; lane l scores key l of the tile against the warp's 8 rows (the K
//     rows are padded to 132 floats so the 16-byte loads are conflict-free,
//     Q reads are broadcasts), and for PV lane l owns output dims 4l..4l+3.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int TQ = 64;
constexpr int TK = 32;
constexpr int WARPS = 8;
constexpr int RPW = TQ / WARPS;
constexpr int KSTRIDE = HD + 4;
constexpr int kThreads = WARPS * 32;
constexpr float kNeg = -1e30f;
constexpr size_t kSmem =
    sizeof(float) * (TQ * HD + TK * KSTRIDE + TK * HD + WARPS * RPW * TK);

// 8 bf16 (one 16-byte load) -> 8 floats at dst (16-byte aligned)
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst,
                                      bool valid) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (valid) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
    lo = make_float4(a.x, a.y, b.x, b.y);
    hi = make_float4(c.x, c.y, e.x, e.y);
  }
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (ceil(S / TQ), H, B); q/out (B, S, H, HD), k/v (B, S, KV, HD) bf16.
__global__ void __launch_bounds__(kThreads)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const int* __restrict__ plen,
          __nv_bfloat16* __restrict__ out, int S, int H, int KV, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [TQ][HD]
  float* Ks = Qs + TQ * HD;                // [TK][KSTRIDE]
  float* Vs = Ks + TK * KSTRIDE;           // [TK][HD]
  float* Ps = Vs + TK * HD;                // [WARPS][RPW][TK]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pl = min(plen[b], S);

  for (int e = tid; e < TQ * HD / 8; e += kThreads) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    const int s = q0 + r;
    load8(q + (((size_t)b * S + s) * H + h) * HD + c, Qs + r * HD + c, s < S);
  }

  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[rr][c] = 0.f;
  }
  const int row0 = q0 + warp * RPW;
  float* Pw = Ps + warp * RPW * TK;
  const int kend = min(min(S, q0 + TQ), pl);

  for (int kt = 0; kt < kend; kt += TK) {
    __syncthreads();                       // previous tile fully consumed
    for (int e = tid; e < TK * HD / 8; e += kThreads) {
      const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
      const int j = kt + r;
      const size_t off = (((size_t)b * S + j) * KV + kvh) * HD + c;
      load8(k + off, Ks + r * KSTRIDE + c, j < S);
      load8(v + off, Vs + r * HD + c, j < S);
    }
    __syncthreads();

    float sc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) sc[rr] = 0.f;
    const float* krow = Ks + lane * KSTRIDE;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (warp * RPW + rr) * HD + d);
        sc[rr] = fmaf(qq.x, kk.x, sc[rr]);
        sc[rr] = fmaf(qq.y, kk.y, sc[rr]);
        sc[rr] = fmaf(qq.z, kk.z, sc[rr]);
        sc[rr] = fmaf(qq.w, kk.w, sc[rr]);
      }
    }

    const int j = kt + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const bool valid = (j <= row0 + rr) && (j < pl);
      const float s = valid ? sc[rr] * scale : kNeg;
      const float mnew = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - mnew) : 0.f;
      const float alpha = expf(m[rr] - mnew);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rr][c] *= alpha;
      m[rr] = mnew;
      Pw[rr * TK + lane] = __bfloat162float(__float2bfloat16_rn(p));
    }
    __syncwarp();

#pragma unroll 2
    for (int jj = 0; jj < TK; jj += 4) {
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + (jj + 0) * HD + lane * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + (jj + 1) * HD + lane * 4);
      const float4 v2 = *reinterpret_cast<const float4*>(Vs + (jj + 2) * HD + lane * 4);
      const float4 v3 = *reinterpret_cast<const float4*>(Vs + (jj + 3) * HD + lane * 4);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + rr * TK + jj);
        acc[rr][0] += p.x * v0.x + p.y * v1.x + p.z * v2.x + p.w * v3.x;
        acc[rr][1] += p.x * v0.y + p.y * v1.y + p.z * v2.y + p.w * v3.y;
        acc[rr][2] += p.x * v0.z + p.y * v1.z + p.z * v2.z + p.w * v3.z;
        acc[rr][3] += p.x * v0.w + p.y * v1.w + p.z * v2.w + p.w * v3.w;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = row0 + rr;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * S + s) * H + h) * HD + lane * 4);
    o[0] = __floats2bfloat162_rn(acc[rr][0] * inv, acc[rr][1] * inv);
    o[1] = __floats2bfloat162_rn(acc[rr][2] * inv, acc[rr][3] * inv);
  }
}

}  // namespace

// q/out (B, S, H, hd), k/v (B, S, KV, hd): contiguous bf16; plen (B,)
// int32 on the device. hd must be 128 and H a multiple of KV.
// Returns the CUDA error code (0 = success).
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
