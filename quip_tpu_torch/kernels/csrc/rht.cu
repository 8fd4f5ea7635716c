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
// the larger. What sets its time is latency: the launch, one round of loads
// from L2, and two dependent products. Two kernels:
//
// rht_mma (T = bf16, the serving dtype). Every operand is a bf16 value, so
// both products are exact tensor-core products (mma.sync.m16n8k16, f32
// accumulators): the function is the same, only the order of the f32 sums
// changes.
//   * a block of 1024 threads owns 16 output columns q (two n-tiles) of one
//     row of x, so the grid is (ceil(b / 16), rows): 4 to 16 blocks a row,
//     twice the CUDA-core kernel's, and no sum crosses blocks. Every block of
//     a row stages the whole X tile, so with many rows (B ceil(b / 64) at
//     least half the SMs) a block owns 64 columns instead, and beyond two
//     blocks an SM it takes several rows in turn (the wrapper's block_plan)
//     and stages L and its slice of R once for them;
//   * operands live in shared memory as bf16 (half the f32 kernel's bytes:
//     X 128 x 250 is 66 KB, L 34 KB, the R slice 12 KB, Z 6 KB), rows padded
//     by 16 bytes so that every ldmatrix is conflict-free; a, b and the
//     block's columns are padded with zeros to multiples of 16;
//   * L, R and vec are f32 in device memory and are rounded on the way in, so
//     the staging goes through registers and cp.async is not used. Staged
//     two elements a load from 256 threads, this alone took as long as the
//     CUDA-core kernel; now x goes 8 elements and L and vec 4 a load, from
//     1024 threads, and all three operands are requested before the first
//     barrier, so one round of L2 latency covers them. One SM's L2 port then bounds a block: 190 KB of x and vec at
//     n = 32000 forward;
//   * the orientation is never materialised: T(R)^T is the R slice's rows as
//     the "col" B operand, T(R) its columns by ldmatrix.trans; T(L)^T is L
//     by ldmatrix.trans as the A operand; Z goes once through shared memory
//     as bf16 (the rounding between the products is part of the function)
//     and comes back by ldmatrix.trans;
//   * a warp's task is one 16-row m-tile by 16 columns (8 tasks for a
//     128-row factor at 16 columns, 32 at 64); vec folds in T on the way in
//     (forward) or out (transpose).
// It runs within a few microseconds of an empty kernel's replay, which
// chip_smoke.py times beside it (quip_rht_empty).
//
// rht_kernel (T = f32: the parity path, round trip at 1e-5). TF32 or bf16
// tensor-core products would change the function, so it keeps the FMA route
// on the CUDA cores:
//   * a block owns one row of x and 32 output columns q (one lane each), so
//     the grid is (ceil(b / 32), B); every block of a row stages the whole
//     (a, b) row (read from L2 after the first);
//   * the row, the block's slice of R and the intermediate Z live in shared
//     memory as f32 (only 32 columns of a 250 x 250 R are staged, transposed
//     to [j][q] with a row stride of 33 words: conflict-free both ways);
//   * each warp computes 4 rows x 32 columns at a time: the x row is read
//     as float4 broadcasts, the R slice as one conflict-free word per lane;
//   * L is staged in chunks (all of a 64 x 64 L at once, 32 columns of a
//     128-row L), laid out [i][p], so that the L product reads it as float4
//     broadcasts too; a warp keeps 2 tiles of 4 rows in registers across the
//     chunks, and the first chunk is staged with the row;
//   * the row is staged two elements per load, four loads deep.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// two neighbouring elements in one load (p is aligned to the pair)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// round to T, held as f32
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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

// ---- the bf16 kernel: both products on the tensor cores -------------------

constexpr int kMT = 1024;       // threads of rht_mma
constexpr int kMW = kMT / 32;

__host__ __device__ inline int up16(int v) { return (v + 15) / 16 * 16; }

// NT n-tiles (8 output columns each) per block; rows of Z and of the
// transposed R slice are 8 * NT + 8 elements long
struct MmaSmem {
  int ap, kb, ldx, ldl, ldz;
  size_t xs, ls, rs, zs, bytes;   // offsets and total, in bytes
};
__host__ __device__ inline MmaSmem mma_smem(int a, int b, int has_right,
                                            int nt) {
  MmaSmem m;
  const int cq = 8 * nt;
  m.ap = up16(a);
  m.kb = has_right ? up16(b) : 0;
  m.ldx = m.kb + 8;
  m.ldl = m.ap + 8;
  m.ldz = cq + 8;
  const size_t rfwd = (size_t)cq * m.ldx, rtr = (size_t)m.kb * m.ldz;
  m.xs = 0;
  m.ls = m.xs + (has_right ? (size_t)m.ap * m.ldx * 2 : 0);
  m.rs = m.ls + (size_t)m.ap * m.ldl * 2;
  m.zs = m.rs + (has_right ? (rfwd > rtr ? rfwd : rtr) * 2 : 0);
  m.bytes = m.zs + (size_t)m.ap * m.ldz * 2;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
  return bf2_bits(__floats2bfloat162_rn(lo, hi));
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
// two neighbouring f32 of a row-major matrix, rounded to bf16; (r, c) outside
// (rows, cols) reads as zero. `even`: cols is even, so the pair is aligned
// and inside together.
__device__ __forceinline__ uint32_t ld_f32_pair(const float* __restrict__ m,
                                                int r, int c, int rows,
                                                int cols, bool even) {
  if (r >= rows || c >= cols) return 0u;
  const float* p = m + (size_t)r * cols + c;
  if (even) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return bf2_bits(v.x, v.y);
  }
  return bf2_bits(__ldg(p), c + 1 < cols ? __ldg(p + 1) : 0.f);
}

// grid (ceil(b / (8 NT)), ceil(B / rpb)); dynamic shared memory per mma_smem.
template <int NT>
__global__ void __launch_bounds__(kMT)
rht_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ vec,
        const float* __restrict__ L, const float* __restrict__ R,
        __nv_bfloat16* __restrict__ y, int B, int a, int b, int rpb,
        int transpose) {
  constexpr int CQ = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem sm = mma_smem(a, b, R != nullptr, NT);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.xs);
  __nv_bfloat16* Ls = reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.ls);
  __nv_bfloat16* Rs = reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.rs);
  __nv_bfloat16* Zs = reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.zs);
  const int ap = sm.ap, kb = sm.kb, ldx = sm.ldx, ldl = sm.ldl, ldz = sm.ldz;
  const int n = a * b;
  const int q0 = blockIdx.x * CQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool b_even = (b & 1) == 0, a_even = (a & 1) == 0;
  // 16-byte loads over the flat row: pairs never straddle a row of X
  const bool x_flat = b_even && n % 8 == 0;

  // the X tile of one row of x: Xs[i][j] = T(x[i][j] * T(vec[i][j])) (forward)
  // or x[i][j], zero outside (a, b)
  auto stage_x = [&](int row) {
    const __nv_bfloat16* xr = x + (size_t)row * n;
    if (x_flat) {
#pragma unroll 2
      for (int e = tid * 8; e < n; e += kMT * 8) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xr + e);
        uint32_t v[4] = {xv.x, xv.y, xv.z, xv.w};
        if (!transpose) {
          const float4 s0 = __ldg(reinterpret_cast<const float4*>(vec + e));
          const float4 s1 = __ldg(reinterpret_cast<const float4*>(vec + e + 4));
          v[0] = bf2_bits(__hmul2(as_bf2(v[0]), as_bf2(bf2_bits(s0.x, s0.y))));
          v[1] = bf2_bits(__hmul2(as_bf2(v[1]), as_bf2(bf2_bits(s0.z, s0.w))));
          v[2] = bf2_bits(__hmul2(as_bf2(v[2]), as_bf2(bf2_bits(s1.x, s1.y))));
          v[3] = bf2_bits(__hmul2(as_bf2(v[3]), as_bf2(bf2_bits(s1.z, s1.w))));
        }
        int i = e / b, j = e - i * b;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          *reinterpret_cast<uint32_t*>(Xs + i * ldx + j) = v[u];
          j += 2;
          if (j >= b) {
            j -= b;
            ++i;
          }
        }
      }
      return;
    }
    const int half = kb / 2;
#pragma unroll 4
    for (int e = tid; e < a * half; e += kMT) {
      const int i = e / half, j = 2 * (e - i * half);
      uint32_t v = 0u;
      if (j < b) {
        const size_t at = (size_t)i * b + j;
        const bool two = j + 1 < b;
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        __nv_bfloat162 xv(xr[at], two ? xr[at + 1] : zero);
        if (!transpose)
          xv = __hmul2(xv, __floats2bfloat162_rn(
                               __ldg(vec + at), two ? __ldg(vec + at + 1) : 0.f));
        v = bf2_bits(xv);
      }
      *reinterpret_cast<uint32_t*>(Xs + i * ldx + j) = v;
    }
  };

  const int row0 = blockIdx.y * rpb;
  const int row_end = min(B, row0 + rpb);
  if (R != nullptr) {
    stage_x(row0);
    // the pads of X that stage_x leaves alone: columns b.. of rows < a (flat
    // staging only) and rows a..
    if (x_flat) {
      const int pc = (kb - b) / 2;
      for (int e = tid; e < a * pc; e += kMT) {
        const int i = e / pc, j = b + 2 * (e - i * pc);
        *reinterpret_cast<uint32_t*>(Xs + i * ldx + j) = 0u;
      }
    }
    for (int e = tid; e < (ap - a) * (kb / 2); e += kMT) {
      const int i = a + e / (kb / 2), j = 2 * (e % (kb / 2));
      *reinterpret_cast<uint32_t*>(Xs + i * ldx + j) = 0u;
    }
    if (!transpose) {
      // Rs[ql][j] = T(R[q0 + ql][j]): the "col" B operand of Z = X . R^T
      const int half = kb / 2;
#pragma unroll 2
      for (int e = tid; e < CQ * half; e += kMT) {
        const int ql = e / half, j = 2 * (e - ql * half);
        *reinterpret_cast<uint32_t*>(Rs + ql * ldx + j) =
            ld_f32_pair(R, q0 + ql, j, b, b, b_even);
      }
    } else {
      // Rs[j][ql] = T(R[j][q0 + ql]): read by ldmatrix.trans for Z = X . R
#pragma unroll 2
      for (int e = tid; e < kb * (CQ / 2); e += kMT) {
        const int j = e / (CQ / 2), ql = 2 * (e - j * (CQ / 2));
        *reinterpret_cast<uint32_t*>(Rs + j * ldz + ql) =
            ld_f32_pair(R, j, q0 + ql, b, b, b_even);
      }
    }
  }
  // Ls[r][c] = T(L[r][c]), zero outside (a, a)
  if (a % 16 == 0) {
#pragma unroll 4
    for (int e = tid * 4; e < a * a; e += kMT * 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(L + e));
      const int r = e / a, c = e - r * a;
      *reinterpret_cast<uint2*>(Ls + r * ldl + c) =
          make_uint2(bf2_bits(v.x, v.y), bf2_bits(v.z, v.w));
    }
  } else {
    const int half = ap / 2;
    for (int e = tid; e < ap * half; e += kMT) {
      const int r = e / half, c = 2 * (e - r * half);
      *reinterpret_cast<uint32_t*>(Ls + r * ldl + c) =
          ld_f32_pair(L, r, c, a, a, a_even);
    }
  }

  // a warp's task: 16 rows (m-tile mt) by 16 columns (n-tiles 2 ng, 2 ng + 1)
  const int tasks = (ap / 16) * (NT / 2);
  for (int row = row0; row < row_end; ++row) {
    if (R == nullptr) {
      // b == 1: Z is the (vec-folded) row itself, in column 0
      for (int e = tid; e < ap * (CQ / 2); e += kMT) {
        const int i = e / (CQ / 2), c = 2 * (e - i * (CQ / 2));
        uint32_t v = 0u;
        if (c == 0 && i < a) {
          __nv_bfloat16 xv = x[(size_t)row * n + i];
          if (!transpose) xv = __hmul(xv, __float2bfloat16_rn(__ldg(vec + i)));
          v = (uint32_t)(*reinterpret_cast<const unsigned short*>(&xv));
        }
        *reinterpret_cast<uint32_t*>(Zs + i * ldz + c) = v;
      }
    } else {
      if (row != row0) stage_x(row);
      __syncthreads();                     // Xs, Rs (and Ls) are written
      // Z[i][q] = T(sum_j X[i][j] Rop[j][q])
      for (int task = warp; task < tasks; task += kMW) {
        const int mt = task % (ap / 16), ng = task / (ap / 16);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint32_t a_base =
            smem_u32(Xs + (mt * 16 + (lane & 15)) * ldx + (lane >> 4) * 8);
        const uint32_t b_base = transpose
            ? smem_u32(Rs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldz +
                       ng * 16 + (lane >> 4) * 8)
            : smem_u32(Rs + (ng * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldx +
                       ((lane >> 3) & 1) * 8);
#pragma unroll 4
        for (int k0 = 0; k0 < kb; k0 += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, a_base + k0 * 2);
          if (transpose)
            ldmatrix_x4_trans(bf, b_base + k0 * ldz * 2);
          else
            ldmatrix_x4(bf, b_base + k0 * 2);
          mma_bf16(acc[0], af, bf[0], bf[1]);
          mma_bf16(acc[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          __nv_bfloat16* z = Zs + (mt * 16 + g) * ldz + ng * 16 + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(z) = bf2_bits(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<uint32_t*>(z + 8 * ldz) =
              bf2_bits(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();                       // Zs (and Ls) are written
    // Y[p][q] = T(sum_i Lop[p][i] Z[i][q]), Lop = T(L) or T(L)^T
    for (int task = warp; task < tasks; task += kMW) {
      const int mt = task % (ap / 16), ng = task / (ap / 16);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t a_base = transpose
          ? smem_u32(Ls + ((lane & 7) + ((lane >> 4) & 1) * 8) * ldl +
                     mt * 16 + ((lane >> 3) & 1) * 8)
          : smem_u32(Ls + (mt * 16 + (lane & 15)) * ldl + (lane >> 4) * 8);
      const uint32_t b_base =
          smem_u32(Zs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldz + ng * 16 +
                   (lane >> 4) * 8);
#pragma unroll 4
      for (int k0 = 0; k0 < ap; k0 += 16) {
        uint32_t af[4], bf[4];
        if (transpose)
          ldmatrix_x4_trans(af, a_base + k0 * ldl * 2);
        else
          ldmatrix_x4(af, a_base + k0 * 2);
        ldmatrix_x4_trans(bf, b_base + k0 * ldz * 2);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
      __nv_bfloat16* yr = y + (size_t)row * n;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + g + 8 * hh;
          const int q = q0 + ng * 16 + nt * 8 + 2 * t;
          if (p >= a || q >= b) continue;
          const size_t at = (size_t)p * b + q;
          const bool two = q + 1 < b;
          __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
          if (transpose)
            v = __hmul2(v, __floats2bfloat162_rn(
                               __ldg(vec + at), two ? __ldg(vec + at + 1) : 0.f));
          if (b_even) {
            *reinterpret_cast<__nv_bfloat162*>(yr + at) = v;
          } else {
            yr[at] = v.x;
            if (two) yr[at + 1] = v.y;
          }
        }
    }
    __syncthreads();                       // Zs is free for the next row
  }
}

__global__ void empty_kernel() {}

template <int NT>
cudaError_t run_mma(const __nv_bfloat16* x, int B, int a, int b,
                    const float* vec, const float* L, const float* R,
                    int transpose, int rpb, __nv_bfloat16* y, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rht_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = mma_smem(a, b, R != nullptr, NT).bytes;
  const int rows = (B + rpb - 1) / rpb;
  if (smem > (size_t)kMaxSmem || rpb < 1 || rows > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((b + 8 * NT - 1) / (8 * NT), rows);
  rht_mma<NT><<<grid, kMT, smem, s>>>(x, vec, L, R, y, B, a, b, rpb,
                                      transpose);
  return cudaGetLastError();
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
// b == 1, no R) in the bf16 (is_bf16 = 1) or the f32 kernel; the wrapper
// refuses shapes above the 227 KB a block can have.
extern "C" long long quip_rht_smem_bytes(int is_bf16, int a, int b,
                                         int has_right, int cols) {
  if (is_bf16) return (long long)mma_smem(a, b, has_right, cols / 8).bytes;
  return (long long)(smem_floats(a, has_right ? (b + 3) / 4 * 4 : 0) *
                     sizeof(float));
}

// x, y (B, a*b) of one dtype: bf16 (is_bf16 = 1) or f32. vec (a*b,), L
// (a, a), R (b, b) f32; R may be null when b == 1. The bf16 kernel's block
// owns cols (16 or 64) output columns and takes rows_per_block >= 1 rows of x
// in turn; the f32 kernel reads neither. Returns the CUDA error code (0 =
// success).
extern "C" int quip_rht_apply(const void* x, int is_bf16, int B, int a, int b,
                              const void* vec, const void* L, const void* R,
                              int transpose, int cols, int rows_per_block,
                              void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vec);
  const float* l = static_cast<const float*>(L);
  const float* r = static_cast<const float*>(R);
  if (B < 1 || a < 1 || b < 1 || (r == nullptr && b != 1))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    if (cols == 16)
      return (int)run_mma<2>(xb, B, a, b, v, l, r, transpose, rows_per_block,
                             yb, s);
    if (cols == 64)
      return (int)run_mma<8>(xb, B, a, b, v, l, r, transpose, rows_per_block,
                             yb, s);
    return (int)cudaErrorInvalidValue;
  }
  return (int)run<float>(static_cast<const float*>(x), B, a, b, v, l, r,
                         transpose, static_cast<float*>(y), s);
}

// One launch of a kernel that does nothing: the floor under any kernel's time
// when launches are replayed from a CUDA graph.
extern "C" int quip_rht_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
