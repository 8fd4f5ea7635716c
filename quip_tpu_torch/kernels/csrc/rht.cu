// K3: one fused randomized-Hadamard/Kronecker (RHT) application for Hopper
// (sm_90a), along the last axis of x (B, n), n = a * b.
//
// Replaces the Pallas kernels quip_tpu/kernels/rht.py (rht_apply_fused ->
// _kernel3, and _kernel2 for the right-factor-free case). Same function and
// the same roundings, with T = x's dtype (bf16 or f32) and X = reshape_{a,b}:
//   forward:    X <- T(X * T(vec));  Z = T(X . T(R)^T);  Y = T(T(L) . Z)
//   transpose:  Z = T(X . T(R));  Y = T(T(L)^T . Z);  Y <- T(Y * T(vec))
// Both products accumulate in f32. L, R and vec arrive f32 and are rounded
// to T here. R == nullptr is the b == 1 case (n == a): the R product is
// skipped. L and R are any square matrices: the products are dense.
//
// Bound on this card: by the roofline its bytes (one row is at most 125 KB,
// L and R at most 64 KB + 244 KB, shared by all rows through L2) and its
// 2.a.b.(a + b) operations per row are both far below a microsecond, bytes
// the larger. What sets its time is the CUDA-core product rate of the few
// blocks a small batch gives it and the latency of their dependent phases.
// Design:
//   * a block owns one row of x and 32 output columns q (one lane each), so
//     the grid is (ceil(b / 32), B) and no sum crosses blocks; every block
//     of a row stages the whole (a, b) row (read from L2 after the first);
//   * the row, the block's slice of R and the intermediate Z live in shared
//     memory as f32 holding T-rounded values (a 250 x 250 R does not fit a
//     block: only its 32 columns are staged, transposed to [j][q] with a
//     row stride of 33 words so that both the staging stores and the
//     product's loads are free of bank conflicts);
//   * each warp computes 4 rows x 32 columns at a time: the x row is read
//     as float4 broadcasts, the R slice as one conflict-free word per lane;
//   * L is staged in chunks (all of a 64 x 64 L at once, 32 columns of a
//     128-row L), rounded and laid out [i][p], so that the L product reads
//     it as float4 broadcasts too; a warp keeps 2 tiles of 4 rows in
//     registers across the chunks, and the first chunk is staged with the
//     row so that its latency hides behind the R product;
//   * the row is staged two elements per load, four loads deep: with one
//     block per SM (the row takes most of the shared memory) the loads in
//     flight, not the bandwidth, set the staging time.
// One block per (row, 32 columns) leaves most of the 132 SMs idle at
// B = 1; using the tensor cores, a Walsh-Hadamard butterfly for L and a
// finer split are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;        // output columns per block: one per lane
constexpr int kRS = kBQ + 1;   // row stride of the staged R slice
constexpr int kIR = 4;         // rows per warp tile
constexpr int kPT = 2;         // tiles a warp holds in the L product
constexpr int kPB = kWarps * kIR * kPT;   // rows of Y per pass (128)
constexpr int kLFloats = 64 * 68;   // staged L chunk: all of a 64 x 64 L,
                                    // or 32 columns of 128 rows
constexpr int kMaxSmem = 227 * 1024;
static_assert(kBQ == 32 && kIR == 4, "lane and float4 maps");
static_assert(32 * (kPB + 4) <= kLFloats, "a chunk holds 32 columns");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// two neighbouring elements in one load (p is aligned to the pair)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// round to T, held as f32
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline size_t smem_floats(int a, int bs) {
  return (size_t)a * bs + (size_t)bs * kRS + (size_t)a * kBQ + kLFloats;
}

// grid (ceil(b / kBQ), B). bs = b rounded up to a multiple of 4 (0 when R
// is null). Shared memory, all f32: xs [a][bs], rs [bs][kRS], zs [a][kBQ],
// ls [lc][lstride] (a chunk of L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rht_kernel(const T* __restrict__ x, const float* __restrict__ vec,
           const float* __restrict__ L, const float* __restrict__ R,
           T* __restrict__ y, int a, int b, int bs, int transpose) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* rs = xs + (size_t)a * bs;
  float* zs = rs + (size_t)bs * kRS;
  float* ls = zs + (size_t)a * kBQ;
  const int n = a * b;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = q0 + lane;
  const T* xr = x + (size_t)blockIdx.y * n;
  T* yr = y + (size_t)blockIdx.y * n;

  // L chunks: rows pb.. (at most kPB) by columns i0.. (lc), laid out
  // ls[ii][pl] = Lop[pb + pl][i0 + ii], Lop = T(L) or T(L)^T; a warp's
  // lanes run along L's rows so that the reads coalesce
  const int lstride = min(kPB, (a + 3) / 4 * 4) + 4;
  const int lc = min(a, kLFloats / lstride);
  auto stage_l = [&](int pb, int i0) {
    const int pn = min(kPB, (a - pb + 3) / 4 * 4);
    if (!transpose) {
      for (int pl = warp; pl < pn; pl += kWarps) {
#pragma unroll 2
        for (int ii = lane; ii < lc; ii += 32)
          ls[ii * lstride + pl] = (pb + pl < a && i0 + ii < a)
              ? rnd<T>(__ldg(L + (size_t)(pb + pl) * a + i0 + ii)) : 0.f;
      }
    } else {
      for (int ii = warp; ii < lc; ii += kWarps) {
#pragma unroll 4
        for (int pl = lane; pl < pn; pl += 32)
          ls[ii * lstride + pl] = (pb + pl < a && i0 + ii < a)
              ? rnd<T>(__ldg(L + (size_t)(i0 + ii) * a + pb + pl)) : 0.f;
      }
    }
  };

  if (R == nullptr) {
    // b == 1: Z is the (vec-folded) row itself, in column 0
    for (int i = tid; i < a; i += kThreads) {
      float v = ld(xr + i);
      if (!transpose) v = rnd<T>(v * rnd<T>(vec[i]));
      zs[i * kBQ] = v;
    }
    stage_l(0, 0);
  } else {
    if (b % 2 == 0) {
      // pairs never straddle a row; two elements per load keep enough
      // bytes in flight for one block per SM
#pragma unroll 4
      for (int e = tid * 2; e < n; e += kThreads * 2) {
        const int i = e / b, j = e - i * b;
        float2 v = ld2(xr + e);
        if (!transpose) {
          const float2 s = __ldg(reinterpret_cast<const float2*>(vec + e));
          v.x = rnd<T>(v.x * rnd<T>(s.x));
          v.y = rnd<T>(v.y * rnd<T>(s.y));
        }
        xs[i * bs + j] = v.x;
        xs[i * bs + j + 1] = v.y;
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < n; e += kThreads) {
        const int i = e / b, j = e - i * b;
        float v = ld(xr + e);
        if (!transpose) v = rnd<T>(v * rnd<T>(__ldg(vec + e)));
        xs[i * bs + j] = v;
      }
    }
    for (int e = tid; e < a * (bs - b); e += kThreads)   // the pad columns
      xs[(e / (bs - b)) * bs + b + e % (bs - b)] = 0.f;
    // rs[j][ql] = T(R)[q0 + ql][j] (forward, Z = X . R^T) or
    // T(R)[j][q0 + ql] (transpose, Z = X . R); lanes along R's rows
    if (!transpose) {
      for (int ql = warp; ql < kBQ; ql += kWarps) {
#pragma unroll 4
        for (int j = lane; j < bs; j += 32)
          rs[j * kRS + ql] = (j < b && q0 + ql < b)
              ? rnd<T>(__ldg(R + (size_t)(q0 + ql) * b + j)) : 0.f;
      }
    } else {
#pragma unroll 4
      for (int j = warp; j < bs; j += kWarps)
        rs[j * kRS + lane] =
            (j < b && q < b) ? rnd<T>(__ldg(R + (size_t)j * b + q)) : 0.f;
    }
    stage_l(0, 0);
    __syncthreads();
    // Z[i][q] = T(sum_j X[i][j] * rs[j][q])
    for (int i0 = warp * kIR; i0 < a; i0 += kWarps * kIR) {
      float acc[kIR];
      const float* xrow[kIR];
#pragma unroll
      for (int u = 0; u < kIR; ++u) {
        acc[u] = 0.f;
        xrow[u] = xs + (size_t)min(i0 + u, a - 1) * bs;
      }
      for (int j = 0; j < bs; j += 4) {
        const float r0 = rs[(j + 0) * kRS + lane];
        const float r1 = rs[(j + 1) * kRS + lane];
        const float r2 = rs[(j + 2) * kRS + lane];
        const float r3 = rs[(j + 3) * kRS + lane];
#pragma unroll
        for (int u = 0; u < kIR; ++u) {
          const float4 xv = *reinterpret_cast<const float4*>(xrow[u] + j);
          acc[u] = fmaf(xv.x, r0, acc[u]);
          acc[u] = fmaf(xv.y, r1, acc[u]);
          acc[u] = fmaf(xv.z, r2, acc[u]);
          acc[u] = fmaf(xv.w, r3, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kIR; ++u)
        if (i0 + u < a) zs[(i0 + u) * kBQ + lane] = rnd<T>(acc[u]);
    }
  }

  // Y[p][q] = T(sum_i Lop[p][i] * Z[i][q]), kPB rows of Y per pass; tile t
  // of a warp holds rows pb + (t*kWarps + warp)*kIR ..
  for (int pb = 0; pb < a; pb += kPB) {
    float acc[kPT][kIR];
#pragma unroll
    for (int t = 0; t < kPT; ++t) {
#pragma unroll
      for (int u = 0; u < kIR; ++u) acc[t][u] = 0.f;
    }
    for (int i0 = 0; i0 < a; i0 += lc) {
      if (pb != 0 || i0 != 0) {            // chunk (0, 0) is staged above
        __syncthreads();                   // the last chunk is used up
        stage_l(pb, i0);
      }
      __syncthreads();                     // zs and ls are written
      const int cn = min(lc, a - i0);
      for (int ii = 0; ii < cn; ++ii) {
        const float zv = zs[(i0 + ii) * kBQ + lane];
#pragma unroll
        for (int t = 0; t < kPT; ++t) {
          const int pl = (t * kWarps + warp) * kIR;
          if (pb + pl < a) {               // the same for a whole warp
            const float4 lv =
                *reinterpret_cast<const float4*>(ls + ii * lstride + pl);
            acc[t][0] = fmaf(lv.x, zv, acc[t][0]);
            acc[t][1] = fmaf(lv.y, zv, acc[t][1]);
            acc[t][2] = fmaf(lv.z, zv, acc[t][2]);
            acc[t][3] = fmaf(lv.w, zv, acc[t][3]);
          }
        }
      }
    }
    if (q < b) {
#pragma unroll
      for (int t = 0; t < kPT; ++t) {
#pragma unroll
        for (int u = 0; u < kIR; ++u) {
          const int p = pb + (t * kWarps + warp) * kIR + u;
          if (p < a) {
            const size_t at = (size_t)p * b + q;
            float v = rnd<T>(acc[t][u]);
            if (transpose) v = rnd<T>(v * rnd<T>(__ldg(vec + at)));
            st(yr + at, v);
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t run(const T* x, int B, int a, int b, const float* vec,
                const float* L, const float* R, int transpose, T* y,
                cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int bs = R == nullptr ? 0 : (b + 3) / 4 * 4;
  const size_t smem = smem_floats(a, bs) * sizeof(float);
  if (smem > (size_t)kMaxSmem || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((b + kBQ - 1) / kBQ, B);
  rht_kernel<T><<<grid, kThreads, smem, s>>>(x, vec, L, R, y, a, b, bs,
                                             transpose);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one block needs for an (a, b) split (has_right = 0:
// b == 1, no R); the wrapper refuses shapes above the 227 KB a block can
// have.
extern "C" long long quip_rht_smem_bytes(int a, int b, int has_right) {
  return (long long)(smem_floats(a, has_right ? (b + 3) / 4 * 4 : 0) *
                     sizeof(float));
}

// x, y (B, a*b) of one dtype: bf16 (is_bf16 = 1) or f32. vec (a*b,), L
// (a, a), R (b, b) f32; R may be null when b == 1. Returns the CUDA error
// code (0 = success).
extern "C" int quip_rht_apply(const void* x, int is_bf16, int B, int a, int b,
                              const void* vec, const void* L, const void* R,
                              int transpose, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vec);
  const float* l = static_cast<const float*>(L);
  const float* r = static_cast<const float*>(R);
  if (B < 1 || a < 1 || b < 1 || (r == nullptr && b != 1))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), B, a,
                                   b, v, l, r, transpose,
                                   static_cast<__nv_bfloat16*>(y), s);
  return (int)run<float>(static_cast<const float*>(x), B, a, b, v, l, r,
                         transpose, static_cast<float*>(y), s);
}
