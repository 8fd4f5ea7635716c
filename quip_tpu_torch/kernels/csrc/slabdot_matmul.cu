// K1': packed dequant-matmul by the slab-dot route (qfn-b) for Hopper
// (sm_90a): y = s . ((2/maxq) . (bf16(x) . codes^T) - sum(bf16(x))).
//
// Replaces the Pallas kernel scripts/bench_kernel.py (slabdot_matmul ->
// _slabdot_kernel), the microbenchmark's variant of K1. The function is
// K1's for qfn-b; the arithmetic is the variant's own and stays so:
//   * field k of a plane's words becomes a slab of bf16 values 128 + c by
//     masking the field in both half-words and OR-ing 0x43004300 (bf16
//     0x4300 = 128, and a code fills the low mantissa bits exactly); there
//     is no int->float convert and no subtraction per element;
//   * each slab is dotted against its contiguous x chunk
//     x[:, k.2nw : (k+1).2nw] with f32 accumulation;
//   * the 128 offset leaves once per plane, as -128 . sum(x) in f32, then
//     the plane weights and the qfn-b affine map apply.
// K1 subtracts the offset per element instead, which is exact; this variant
// pays f32 digits for it (sums of magnitude 128 . |x| . sqrt(d)), which is
// why the microbenchmark's agreement limit is 2e-2 of max |y|. The operands
// are exactly what a bf16 tensor-core product takes; here the products run
// on the CUDA cores.
//
// Bound on this card: the packed planes' bytes (device-memory bandwidth),
// next the issue rate of the unpack. Design, shared with K1 (same plane
// layout: word (j, i), field k, half h = code of row i, fan-in column
// k.2nw + 2j + h):
// one thread per output column so that a warp's plane-word load is one
// coalesced 128-byte transaction; word rows split over grid.y with a second
// kernel summing the partials; the bf16(x) columns a chunk touches staged
// in shared memory as f32 (broadcast reads). A block owns tile_m output
// columns (the argument the microbenchmark sweeps) and walks them 128 at a
// time, staging its x chunk once.
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
  constexpr uint32_t MASK = ((1u << FB) - 1u) * 0x00010001u;
#pragma unroll
  for (int k = 0; k < FPH; ++k) {
    // two bf16 values 128 + c, one per half-word, widened to f32 bits
    const uint32_t slab = ((w >> (FB * k)) & MASK) | 0x43004300u;
    const float c0 = __uint_as_float(slab << 16);
    const float c1 = __uint_as_float(slab & 0xFFFF0000u);
    const float* xk = xs + k * 2 * J + 2 * jj;
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float2 xv = *reinterpret_cast<const float2*>(xk + b * cols);
      acc[b] = fmaf(xv.x, c0, acc[b]);
      acc[b] = fmaf(xv.y, c1, acc[b]);
    }
  }
}

// grid (m / tile_m, splits, ceil(B / TB)); one plane per launch. partial:
// (splits, B, m) f32 sums of x . (128 + c) for this plane. xsum_part:
// (splits, B) or null (written from plane 0, by the blocks with
// blockIdx.x == 0).
template <typename T, int FB, int TB>
__global__ void __launch_bounds__(kThreads)
sd_partial(const T* __restrict__ x, int B, int d,
           const uint32_t* __restrict__ plane, int nw, int m, int tile_m,
           int J, float* __restrict__ partial, float* __restrict__ xsum_part) {
  constexpr int FPH = 16 / FB;
  extern __shared__ float xs[];            // [TB][FPH][2J]
  const int j0 = blockIdx.y * J;
  const int jn = min(J, nw - j0);          // word rows of this chunk
  const int b0 = blockIdx.z * TB;
  const int cols = FPH * 2 * J;

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

  // tile_m is a multiple of kThreads and divides m: every column is real
  for (int c = 0; c < tile_m; c += kThreads) {
    const int i = blockIdx.x * tile_m + c + threadIdx.x;
    float acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0.f;
    const uint32_t* wp = plane + (size_t)j0 * m + i;
    int jj = 0;
    for (; jj + 4 <= jn; jj += 4) {
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = __ldg(wp + (size_t)(jj + u) * m);
#pragma unroll
      for (int u = 0; u < 4; ++u) accum_word<FB, TB>(w[u], xs, cols, J, jj + u, acc);
    }
    for (; jj < jn; ++jj)
      accum_word<FB, TB>(__ldg(wp + (size_t)jj * m), xs, cols, J, jj, acc);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b0 + b < B) partial[((size_t)blockIdx.y * B + b0 + b) * m + i] = acc[b];
  }
}

// One thread per (b, i): sum the split partials per plane, take the 128
// offset out once per plane, weight the planes, apply the qfn-b map.
template <typename T>
__global__ void sd_finish(const float* __restrict__ partial, int nplanes,
                          int splits, int B, int m, float pw0, float pw1,
                          const float* __restrict__ xsum_part, float maxq,
                          const float* __restrict__ scale, T* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * m) return;
  const int b = (int)(idx / m);
  const int i = (int)(idx - (size_t)b * m);
  float xsum = 0.f;
  for (int y = 0; y < splits; ++y) xsum += xsum_part[(size_t)y * B + b];
  float ycodes = 0.f;
  for (int p = 0; p < nplanes; ++p) {
    float s = 0.f;
    for (int y = 0; y < splits; ++y)
      s += partial[(((size_t)p * splits + y) * B + b) * m + i];
    ycodes += (p == 0 ? pw0 : pw1) * (s - 128.0f * xsum);
  }
  store(out + idx, scale[0] * ((2.0f / maxq) * ycodes - xsum));
}

template <typename T, int FB, int TB>
cudaError_t launch_partial(const T* x, int B, int d, const uint32_t* plane,
                           int nw, int m, int tile_m, int splits,
                           float* partial, float* xsum_part,
                           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sd_partial<T, FB, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int J = (nw + splits - 1) / splits;
  const size_t smem = (size_t)TB * (16 / FB) * 2 * J * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid(m / tile_m, splits, (B + TB - 1) / TB);
  sd_partial<T, FB, TB><<<grid, kThreads, smem, stream>>>(
      x, B, d, plane, nw, m, tile_m, J, partial, xsum_part);
  return cudaGetLastError();
}

template <typename T, int FB>
cudaError_t launch_fb(int tb, const T* x, int B, int d, const uint32_t* plane,
                      int nw, int m, int tile_m, int splits, float* partial,
                      float* xsum_part, cudaStream_t s) {
  switch (tb) {
    case 1: return launch_partial<T, FB, 1>(x, B, d, plane, nw, m, tile_m, splits, partial, xsum_part, s);
    case 2: return launch_partial<T, FB, 2>(x, B, d, plane, nw, m, tile_m, splits, partial, xsum_part, s);
    case 4: return launch_partial<T, FB, 4>(x, B, d, plane, nw, m, tile_m, splits, partial, xsum_part, s);
    case 8: return launch_partial<T, FB, 8>(x, B, d, plane, nw, m, tile_m, splits, partial, xsum_part, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(const T* x, int B, int d, const void* const* planes,
                const int* fbs, int nplanes, float pw0, float pw1, int m,
                int tile_m, int splits, int tb, float* work, float maxq,
                const float* scale, T* out, cudaStream_t s) {
  float* xsum_part = work + (size_t)nplanes * splits * B * m;
  for (int p = 0; p < nplanes; ++p) {
    const uint32_t* plane = static_cast<const uint32_t*>(planes[p]);
    const int nw = d * fbs[p] / 32;
    float* partial = work + (size_t)p * splits * B * m;
    float* xp = p == 0 ? xsum_part : nullptr;
    cudaError_t e;
    switch (fbs[p]) {
      case 1: e = launch_fb<T, 1>(tb, x, B, d, plane, nw, m, tile_m, splits, partial, xp, s); break;
      case 2: e = launch_fb<T, 2>(tb, x, B, d, plane, nw, m, tile_m, splits, partial, xp, s); break;
      case 4: e = launch_fb<T, 4>(tb, x, B, d, plane, nw, m, tile_m, splits, partial, xp, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  }
  const size_t n = (size_t)B * m;
  const int threads = 256;
  sd_finish<T><<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      work, nplanes, splits, B, m, pw0, pw1, xsum_part, maxq, scale, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, d) and out (B, m) share one dtype: bf16 (is_bf16 = 1) or f32 (x is
// rounded to bf16 inside either way). planes: int32 (d*fb/32, m) each.
// tile_m: a multiple of 128 that divides m. work: f32 scratch of
// nplanes*splits*B*m + splits*B. scale -> one f32 (device). tb: batch tile
// in {1, 2, 4, 8}. Returns the CUDA error code (0 = success).
extern "C" int quip_slabdot_matmul(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m,
    int tile_m, int splits, int tb, void* work, float maxq, const void* scale,
    void* out, void* stream) {
  const void* planes[2] = {plane0, plane1};
  const int fbs[2] = {fb0, fb1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  const float* sc = static_cast<const float*>(scale);
  if (nplanes < 1 || nplanes > 2 || tile_m < kThreads || tile_m % kThreads ||
      m % tile_m)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), B, d, planes, fbs, nplanes,
        pw0, pw1, m, tile_m, splits, tb, w, maxq, sc,
        static_cast<__nv_bfloat16*>(out), s);
  return (int)run<float>(static_cast<const float*>(x), B, d, planes, fbs,
                         nplanes, pw0, pw1, m, tile_m, splits, tb, w, maxq,
                         sc, static_cast<float*>(out), s);
}
