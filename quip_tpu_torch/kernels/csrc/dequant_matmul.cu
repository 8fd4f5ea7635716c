// K1: packed dequant-matmul for Hopper (sm_90a), y = bf16(x) . dequant(planes)^T.
//
// Replaces the Pallas kernel quip_tpu/kernels/dequant_matmul.py
// (_dequant_matmul_local -> _kernel / _plane_codes_dot). Same semantics:
// x is rounded to bf16, products accumulate in f32, planes follow
// pack/format.py (word (j, i), field k, half h = code of row i, fan-in
// column k*2nw + 2j + h), multi-plane widths combine with their plane
// weights, and the qfn-b / qfn-a affine fixups use the sum of bf16(x).
//
// Bound on this card: at decode (B <= 32) the packed planes dominate the
// bytes (2-bit Llama-2-7B: 1.67 GB per step), so the kernel is bound by
// device-memory bandwidth, and next by instruction issue for the unpack.
// Design:
//   * one thread per output column i, neighbouring threads on neighbouring
//     columns, so each plane-word load of a warp is one coalesced 128-byte
//     transaction;
//   * the word rows are split over grid.y (enough blocks to fill 132 SMs
//     even at m = 4096); each block stages only the bf16(x) columns its
//     rows touch (per field k, 2J contiguous columns) in shared memory as
//     f32, so every x read in the inner loop is a same-address broadcast
//     and a float2 load feeds both halves of a word;
//   * codes turn into exact floats with two magic-exponent ORs and one add
//     (no int->float converts, which issue at a quarter rate): half 0 as
//     2^23 + c, half 1 as 128 + c (the field already sits at bit 16);
//   * a second small kernel sums the split partials and the plane weights
//     and applies the affine fixup.
// Prefill (B = prompt length) loops over batch tiles of 8 rows, re-reading
// the planes once per tile (from L2 at these sizes); a tensor-core tile
// GEMM is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int FB, int TB>
__device__ __forceinline__ void accum_word(uint32_t w, const float* xs,
                                           int cols, int J, int jj,
                                           float* acc) {
  constexpr int FPH = 16 / FB;
  constexpr uint32_t MASK = (1u << FB) - 1u;
#pragma unroll
  for (int k = 0; k < FPH; ++k) {
    const uint32_t t = w >> (FB * k);
    const float c0 = __uint_as_float((t & MASK) | 0x4B000000u) - 8388608.0f;
    const float c1 =
        __uint_as_float((t & (MASK << 16)) | 0x43000000u) - 128.0f;
    const float* xk = xs + k * 2 * J + 2 * jj;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float2 xv = *reinterpret_cast<const float2*>(xk + b * cols);
      acc[b] = fmaf(xv.x, c0, acc[b]);
      acc[b] = fmaf(xv.y, c1, acc[b]);
    }
  }
}

// grid (ceil(m_p / 128), splits, ceil(B / TB)); one plane per launch.
// partial: (splits, B, m_p) f32 for this plane. xsum_part: (splits, B) or
// null (written from plane 0 only, by the blocks with blockIdx.x == 0).
template <typename T, int FB, int TB>
__global__ void __launch_bounds__(kThreads)
dm_partial(const T* __restrict__ x, int B, int d,
           const uint32_t* __restrict__ plane, int nw, int m_p, int J,
           float* __restrict__ partial, float* __restrict__ xsum_part) {
  constexpr int FPH = 16 / FB;
  extern __shared__ float xs[];            // [TB][FPH][2J]
  const int j0 = blockIdx.y * J;
  const int jn = min(J, nw - j0);          // word rows of this chunk
  const int b0 = blockIdx.z * TB;
  const int cols = FPH * 2 * J;
  const int i = blockIdx.x * kThreads + threadIdx.x;

  for (int e = threadIdx.x; e < TB * cols; e += kThreads) {
    const int b = e / cols;
    const int r = e - b * cols;
    const int k = r / (2 * J);
    const int q = r - k * 2 * J;           // 2*jj + h
    float v = 0.f;
    if (b0 + b < B && q < 2 * jn)
      v = bf16_round(x[(size_t)(b0 + b) * d + (size_t)k * 2 * nw + 2 * j0 + q]);
    xs[e] = v;
  }
  __syncthreads();

  if (xsum_part != nullptr && blockIdx.x == 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int b = warp; b < TB; b += kThreads / 32) {
      float s = 0.f;
      for (int c = lane; c < cols; c += 32) s += xs[b * cols + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && b0 + b < B) xsum_part[(size_t)blockIdx.y * B + b0 + b] = s;
    }
  }
  if (i >= m_p) return;                    // no barrier follows

  float acc[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[b] = 0.f;
  const uint32_t* wp = plane + (size_t)j0 * m_p + i;
  int jj = 0;
  for (; jj + 4 <= jn; jj += 4) {
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = __ldg(wp + (size_t)(jj + u) * m_p);
#pragma unroll
    for (int u = 0; u < 4; ++u) accum_word<FB, TB>(w[u], xs, cols, J, jj + u, acc);
  }
  for (; jj < jn; ++jj)
    accum_word<FB, TB>(__ldg(wp + (size_t)jj * m_p), xs, cols, J, jj, acc);

#pragma unroll
  for (int b = 0; b < TB; ++b)
    if (b0 + b < B) partial[((size_t)blockIdx.y * B + b0 + b) * m_p + i] = acc[b];
}

// One thread per (b, i): sum split partials per plane, weight the planes,
// apply the qfn fixup. partial: (nplanes, splits, B, m_p).
template <typename T>
__global__ void dm_finish(const float* __restrict__ partial, int nplanes,
                          int splits, int B, int m_p, float pw0, float pw1,
                          const float* __restrict__ xsum_part, int qfn_b,
                          float maxq, const float* __restrict__ scale,
                          const float* __restrict__ zero, T* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * m_p) return;
  const int b = (int)(idx / m_p);
  const int i = (int)(idx - (size_t)b * m_p);
  float ycodes = 0.f;
  for (int p = 0; p < nplanes; ++p) {
    float s = 0.f;
    for (int y = 0; y < splits; ++y)
      s += partial[(((size_t)p * splits + y) * B + b) * m_p + i];
    ycodes += (p == 0 ? pw0 : pw1) * s;
  }
  float xsum = 0.f;
  for (int y = 0; y < splits; ++y) xsum += xsum_part[(size_t)y * B + b];
  float v;
  if (qfn_b) {
    v = scale[0] * ((2.0f / maxq) * ycodes - xsum);
  } else {
    v = scale[i] * ycodes - scale[i] * zero[i] * xsum;
  }
  store(out + idx, v);
}

template <typename T, int FB, int TB>
cudaError_t launch_partial(const T* x, int B, int d, const uint32_t* plane,
                           int nw, int m_p, int splits, float* partial,
                           float* xsum_part, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dm_partial<T, FB, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int J = (nw + splits - 1) / splits;
  const size_t smem = (size_t)TB * (16 / FB) * 2 * J * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid((m_p + kThreads - 1) / kThreads, splits, (B + TB - 1) / TB);
  dm_partial<T, FB, TB><<<grid, kThreads, smem, stream>>>(
      x, B, d, plane, nw, m_p, J, partial, xsum_part);
  return cudaGetLastError();
}

template <typename T, int FB>
cudaError_t launch_fb(int tb, const T* x, int B, int d, const uint32_t* plane,
                      int nw, int m_p, int splits, float* partial,
                      float* xsum_part, cudaStream_t s) {
  switch (tb) {
    case 1: return launch_partial<T, FB, 1>(x, B, d, plane, nw, m_p, splits, partial, xsum_part, s);
    case 2: return launch_partial<T, FB, 2>(x, B, d, plane, nw, m_p, splits, partial, xsum_part, s);
    case 4: return launch_partial<T, FB, 4>(x, B, d, plane, nw, m_p, splits, partial, xsum_part, s);
    case 8: return launch_partial<T, FB, 8>(x, B, d, plane, nw, m_p, splits, partial, xsum_part, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(const T* x, int B, int d, const void* const* planes,
                const int* fbs, int nplanes, float pw0, float pw1, int m_p,
                int splits, int tb, float* work, int qfn_b, float maxq,
                const float* scale, const float* zero, T* out,
                cudaStream_t s) {
  float* xsum_part = work + (size_t)nplanes * splits * B * m_p;
  for (int p = 0; p < nplanes; ++p) {
    const uint32_t* plane = static_cast<const uint32_t*>(planes[p]);
    const int nw = d * fbs[p] / 32;
    float* partial = work + (size_t)p * splits * B * m_p;
    float* xp = p == 0 ? xsum_part : nullptr;
    cudaError_t e;
    switch (fbs[p]) {
      case 1: e = launch_fb<T, 1>(tb, x, B, d, plane, nw, m_p, splits, partial, xp, s); break;
      case 2: e = launch_fb<T, 2>(tb, x, B, d, plane, nw, m_p, splits, partial, xp, s); break;
      case 4: e = launch_fb<T, 4>(tb, x, B, d, plane, nw, m_p, splits, partial, xp, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  }
  const size_t n = (size_t)B * m_p;
  const int threads = 256;
  dm_finish<T><<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      work, nplanes, splits, B, m_p, pw0, pw1, xsum_part, qfn_b, maxq, scale,
      zero, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, d) and out (B, m_p) share one dtype: bf16 (is_bf16 = 1) or f32.
// planes: int32 (d*fb/32, m_p) each. work: f32 scratch of
// nplanes*splits*B*m_p + splits*B. qfn-b: scale -> one f32 (device);
// qfn-a: scale, zero -> (m_p,) f32. tb: batch tile in {1, 2, 4, 8}.
// Returns the CUDA error code (0 = success).
extern "C" int quip_dequant_matmul(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m_p,
    int splits, int tb, void* work, int qfn_b, float maxq, const void* scale,
    const void* zero, void* out, void* stream) {
  const void* planes[2] = {plane0, plane1};
  const int fbs[2] = {fb0, fb1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  const float* sc = static_cast<const float*>(scale);
  const float* ze = static_cast<const float*>(zero);
  if (nplanes < 1 || nplanes > 2) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), B, d, planes, fbs, nplanes,
        pw0, pw1, m_p, splits, tb, w, qfn_b, maxq, sc, ze,
        static_cast<__nv_bfloat16*>(out), s);
  return (int)run<float>(static_cast<const float*>(x), B, d, planes, fbs,
                         nplanes, pw0, pw1, m_p, splits, tb, w, qfn_b, maxq,
                         sc, ze, static_cast<float*>(out), s);
}
