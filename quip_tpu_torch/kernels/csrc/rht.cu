// K3: one fused randomized-Hadamard/Kronecker (RHT) application for Hopper
// (sm_90a), along the last axis of x (B, n), n = a * b.
//
// Replaces the Pallas kernels quip_tpu/kernels/rht.py (rht_apply_fused ->
// _kernel3, and _kernel2 for the right-factor-free case). Same function and
// the same roundings, with T = x's dtype (bf16 or f32) and X = reshape_{a,b}:
//   forward:    X <- T(X * T(vec));  Z = T(X . T(R)^T);  Y = T(T(L) . Z)
//   transpose:  Z = T(X . T(R));  Y = T(T(L)^T . Z);  Y <- T(Y * T(vec))
// Both products accumulate in f32. L and R are any square matrices: the
// products are dense.
//
// Bound on this card: not bytes and not operations. One row is at most 64
// KB of bf16, L and R at most 32 KB + 125 KB, and 2.a.b.(a + b) operations
// a row, all far below a microsecond at 3.35 TB/s and 989 TFLOP/s. Its
// time is the launch, one round trip to L2 for the row of x, and two
// dependent products: in a decode step it sits between K1-decode launches,
// so what counts is how much of that it can hide under its neighbours.
//
// rht_mma (T = bf16, the serving dtype; a <= 128, b <= 256):
//   * programmatic dependent launch (cudaLaunchKernelEx with
//     programmatic stream serialization): the launch and a block's set-up
//     (its barriers, the zeros past x's row) run under the kernel before
//     it; every copy (the operands, x) and every store of y come after
//     griddepcontrol.wait. The block lets the next grid launch as soon as
//     its copies of x are issued, so K1-decode's producer fills its plane
//     ring under this kernel's products. Staging the operands before the
//     wait measured no faster (tools/tune_rht.py, PERF.md section 6);
//   * L, R and vec come as bf16 copies made once (kernels/rht.py's
//     `operands`, cached by the source tensors), zero-padded and already in
//     the layout the kernel reads: L and R as core matrices of 8 rows of
//     16 bytes, k16 slice by k16 slice (desc_plain's: the two halves of a
//     slice 128 bytes apart, 8-row groups 256 apart); vec as x is staged
//     (forward) or as each block's slice (transpose). Each is one bulk
//     copy (cp.async.bulk) and no thread rounds or moves a factor;
//   * a block owns NQ = 32 output columns q of one row of x: one consumer
//     warpgroup and one producer warp (160 threads, at most ~190 KB of
//     shared memory, 120 KB on the serving path's widest U side). Each of
//     the ceil(b / 32) blocks of a row stages the whole row, flat, by one
//     bulk copy an m-tile (rows 0..63 and 64..127 land on mbarriers of
//     their own), from L2 after the first block. A thread-block cluster
//     sharing the row by multicast, and rows padded apart by tensor-map
//     boxes against bank conflicts, both measured no faster;
//   * Z = X . Rop is wgmma.m64n32k16 with X as the register A operand: a
//     lane reads its A fragments straight from the staged row (and folds
//     vec in, forward), 4 k16 slices a batch into one of two register sets
//     while the batch before is in flight, the m-tiles' batches in turn;
//     B is the R slice (K-major, zero-padded to whole batches). With one
//     warp a scheduler every instruction's latency shows, so the even-b
//     loads take no branch: they read a buffer whose rows >= a and tail
//     are zero (past a row's end a read meets the next row's value
//     and R's zero column);
//   * Z is rounded to bf16 in registers and written once, transposed, by
//     stmatrix (.trans) as the K-major B operand of Y = Lop . Z, itself
//     wgmma.m64n32k16 with Lop from shared memory;
//   * the epilogue rounds Y, multiplies the transpose's vec (its block's
//     slice, staged with the operands, read while Y's products run) and
//     stores pairs of y.
// Rows of x that are not 16-byte pieces (n % 8 != 0) are copied by the
// producer warp itself, element by element. What binds it:
// tools/tune_rht.py (ablation, stage clocks; PERF.md section 6).
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

#include "hopper.cuh"

// Stage stamps for tools/tune_rht.py's timed copy; nothing here.
#ifndef RHT_STAMP
#define RHT_STAMP(k)
#endif

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


// ---- the bf16 kernel: both products on wgmma -------------------------------

constexpr int NQ = 32;            // output columns of a block: wgmma's N
constexpr int NCT = 128;          // consumer threads: one warpgroup
constexpr int NTH = NCT + 32;     // and one producer warp
constexpr int BATCH = 4;          // k16 slices of x a batch of Z's products
constexpr int SLICE = 256 * (NQ / 8);   // bytes of a k16 slice of 32 rows
constexpr int VLD = NQ + 8;       // row stride of the transpose's vec slice
constexpr int kMmaSmem = 220 * 1024;

__host__ __device__ inline int up8(int v) { return (v + 7) / 8 * 8; }
// x's and vec's elements in shared memory: 64 mt rows of b, and the tail
// that Z's last k16 slices read past the last row
__host__ __device__ inline int x_len(int a, int b) {
  return up8(64 * ((a + 63) / 64) * b + 64);
}

// The bf16 kernel's shape: mt m-tiles of 64 rows (a), nb batches of
// BATCH k16 slices of b (Z's depth, R zero-padded to it), ks2 k16 slices
// of a (Y's depth), nq blocks a row; dynamic
// shared memory (byte offsets): L (64 mt rows, ks2 slices), this block's R
// slice (32 rows, BATCH nb slices), Z^T (32 rows, ks2 slices), vec
// (forward: as x; transpose: this block's a x 32 slice, rows VLD apart)
// and x (x_len elements).
struct Geo {
  int mt, nb, ks2, nq;
  int l_bytes, r_bytes, v_bytes, x_bytes;
  int ls, rs, zs, vs, xs, bytes;
};
__host__ __device__ inline Geo geo(int a, int b, int transpose) {
  Geo g;
  g.mt = (a + 63) / 64;
  g.nb = (b + 16 * BATCH - 1) / (16 * BATCH);
  g.ks2 = (a + 15) / 16;
  g.nq = (b + NQ - 1) / NQ;
  g.l_bytes = g.ks2 * g.mt * 2048;
  g.r_bytes = BATCH * g.nb * SLICE;
  g.x_bytes = x_len(a, b) * 2;
  g.v_bytes = transpose ? a * VLD * 2 : g.x_bytes;
  g.ls = 0;
  g.rs = g.ls + g.l_bytes;
  g.zs = g.rs + g.r_bytes;
  g.vs = g.zs + g.ks2 * SLICE;
  g.xs = (g.vs + g.v_bytes + 127) / 128 * 128;
  g.bytes = g.xs + g.x_bytes + 128;              // + the base's alignment
  return g;
}

// a 1-D bulk copy global -> shared, completing on `bar`'s transaction
// count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}
// four 8 x 8 bf16 matrices of the accumulator layout, each stored
// transposed: row r of matrix m at the address lane 8 m + r gives
__device__ __forceinline__ void stmatrix_t(uint32_t addr, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
      "\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

#define ACC16(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define REGS16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// D (64 x 32, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 32, K-major
// in shared memory); acc = 0 overwrites D
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// the same with A (64 x 16, K-major) from shared memory too
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(d)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
// Elements e and e + 1 of a bf16 row as one register, zero unless `in`
// (and the second zero unless `two`), without a branch: the loads of a
// batch stay in flight together.
__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* p, int e,
                                            bool in, bool two) {
  const int at = in ? e : 0;
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p + at);
  const uint32_t hi =
      *reinterpret_cast<const unsigned short*>(p + (in && two ? e + 1 : 0));
  return in ? (lo | (two ? hi << 16 : 0u)) : 0u;
}
// A batch of A fragments of X (BATCH k16 slices; rows i0 and i0 + 8 of
// this lane), vec folded in forward, for even b: xp and vp point at this
// lane's first element (row i0, column 16 s0 + 2 t), ld8 is 8 rows. Every
// position read is inside the buffers: past a row's end it is the next
// row's value (Z's R slice is zero there) or zero (rows >= a and the tail
// are zero-filled, vec's prepared so).
__device__ __forceinline__ void x_batch_even(uint32_t (&aq)[BATCH][4],
                                             const __nv_bfloat16* xp,
                                             const __nv_bfloat16* vp,
                                             int ld8, bool fwd) {
#pragma unroll
  for (int u = 0; u < BATCH; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      aq[u][r] = *reinterpret_cast<const uint32_t*>(
          xp + (r & 1) * ld8 + 16 * u + 8 * (r >> 1));
  if (fwd) {
    uint32_t v[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[u][r] = *reinterpret_cast<const uint32_t*>(
            vp + (r & 1) * ld8 + 16 * u + 8 * (r >> 1));
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        aq[u][r] = bits2(__hmul2(bf2(aq[u][r]), bf2(v[u][r])));
  }
}
// the same for odd b: element by element, zero outside (a, b)
__device__ __forceinline__ void x_batch_odd(uint32_t (&aq)[BATCH][4],
                                        const __nv_bfloat16* xs,
                                        const __nv_bfloat16* vs, int i0,
                                        int s0, int t, int a, int b,
                                        bool fwd) {
#pragma unroll
  for (int u = 0; u < BATCH; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 8 * (r & 1), j = 16 * (s0 + u) + 2 * t + 8 * (r >> 1);
      aq[u][r] = pair_at(xs, i * b + j, i < a && j < b, j + 1 < b);
    }
  if (fwd) {
    uint32_t v[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 8 * (r & 1),
                  j = 16 * (s0 + u) + 2 * t + 8 * (r >> 1);
        v[u][r] = pair_at(vs, i * b + j, i < a && j < b, j + 1 < b);
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        aq[u][r] = bits2(__hmul2(bf2(aq[u][r]), bf2(v[u][r])));
  }
}

// grid (nq, B): block qs of a row owns output columns 32 qs .. 32 qs + 31.
// x, y (B, a*b) bf16; vp (forward: as x's buffer, x_len elements, zero
// past a*b; transpose: by block, a rows of the block's 32 columns, VLD
// apart), lp and rp bf16 in the layout above (kernels/rht.py::prepare). MT
// and NB are the shape's (Geo's mt, nb). flat: x arrives by bulk copies
// (x 16-byte aligned, n % 8 == 0), else element by element (the producer
// warp).
template <int MT, int NB>
__global__ void __launch_bounds__(NTH)
rht_mma(const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ vp,
        const __nv_bfloat16* __restrict__ lp,
        const __nv_bfloat16* __restrict__ rp, __nv_bfloat16* __restrict__ y,
        int a, int b, int transpose, int flat) {
  extern __shared__ __align__(128) unsigned char dsm_raw[];
  __shared__ __align__(8) uint64_t fbar, xbar[MT];
  const Geo G = geo(a, b, transpose);
  unsigned char* dsm =
      dsm_raw + ((128 - (smem_u32(dsm_raw) & 127)) & 127);
  unsigned char* Ls = dsm + G.ls;
  unsigned char* Rs = dsm + G.rs;
  unsigned char* Zs = dsm + G.zs;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(dsm + G.vs);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(dsm + G.xs);
  const int n = a * b;
  const int qs = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  RHT_STAMP(0);

  if (tid == 0) {
    mbar_init(&fbar, 1);
    for (int m = 0; m < MT; ++m) mbar_init(&xbar[m], flat ? 1 : 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCT / 32) {
    // ---- producer ---------------------------------------------------------
    grid_dep_wait();            // x belongs to the kernel before
    if (lane == 0) {
      mbar_expect_tx(&fbar, G.l_bytes + G.r_bytes + G.v_bytes);
      bulk_load(Ls, lp, G.l_bytes, &fbar);
      bulk_load(Rs, rp + (size_t)qs * (G.r_bytes / 2), G.r_bytes, &fbar);
      bulk_load(Vs, vp + (transpose ? (size_t)qs * a * VLD : 0), G.v_bytes,
                &fbar);
    }
    const __nv_bfloat16* xr = x + (size_t)row * n;
    if (flat) {
      if (lane == 0) {
        for (int m = 0; m < MT; ++m) {
          // rows 64 m .. of the flat row: 16-byte pieces
          const int e0 = 64 * m * b, e1 = min(a, 64 * m + 64) * b;
          mbar_expect_tx(&xbar[m], (e1 - e0) * 2);
          bulk_load(Xs + e0, xr + e0, (e1 - e0) * 2, &xbar[m]);
        }
      }
    } else {
      for (int e = lane; e < n; e += 32) Xs[e] = xr[e];
      for (int m = 0; m < MT; ++m) mbar_arrive(&xbar[m]);
    }
    __syncwarp();
    grid_dep_launch();          // x's last read is issued
  } else {
    // ---- consumers --------------------------------------------------------
    const int w = warp, g = lane >> 2, t = lane & 3;
    const int q0 = qs * NQ;
    const bool fwd = !transpose, even = (b & 1) == 0;
    // zero what x's copies leave alone and Z's loads read: everything past
    // the row (shared memory only: no need to wait for the kernel before)
    const int xl = x_len(a, b);
    {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int e = up8(n) + 8 * tid; e < xl; e += 8 * NCT)
        *reinterpret_cast<uint4*>(Xs + e) = z;
      for (int e = n + tid; e < up8(n); e += NCT)
        Xs[e] = __float2bfloat16_rn(0.f);
      consumers_sync();
    }
    grid_dep_wait();            // y may alias what the kernel before used
    RHT_STAMP(1);
    mbar_wait(&fbar, 0);
    RHT_STAMP(2);

    // Z[i][q] = T(sum_j X[i][j] RopT[q][j]): batches of BATCH k16 slices,
    // the m-tiles' in turn (independent chains), in two register sets
    float acc[MT][16];
    uint32_t af[2][BATCH][4];
    const uint32_t rs = smem_u32(Rs);
    const int x0 = (16 * w + g) * b + 2 * t;
#pragma unroll
    for (int bt = 0; bt < NB; ++bt)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (bt == 0) {
          mbar_wait(&xbar[m], 0);
          if (m == 0) RHT_STAMP(3);
        }
        const int set = (bt * MT + m) & 1;
        uint32_t(&aq)[BATCH][4] = af[set];
        // every load of the batch in flight before the first pin waits
        if (even) {
          const int at = x0 + 64 * m * b + 16 * BATCH * bt;
          x_batch_even(aq, Xs + at, Vs + at, 8 * b, fwd);
        } else {
          x_batch_odd(aq, Xs, Vs, 64 * m + 16 * w + g, BATCH * bt, t, a, b,
                      fwd);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) pin(aq[u][r]);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int s = BATCH * bt + u;
          wgmma_rs(acc[m], aq[u], desc_plain(rs + s * SLICE, 128), s > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the batch before is retired only now: its registers stay its own
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) pin(af[set ^ 1][u][r]);
      }
    wgmma_wait<0>();
    grid_dep_launch();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) pin(acc[m][e]);
    RHT_STAMP(4);

    // Z^T as Y's K-major B operand: rows q, k16 slice s = 4 m + w of a
    // warp's 16 rows i; matrix mm of a stmatrix is (half mm & 1 of the
    // slice, column group c + mm / 2)
    const uint32_t zs = smem_u32(Zs);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int s = 4 * m + w;
      if (s >= G.ks2) continue;
#pragma unroll
      for (int c = 0; c < NQ / 8; c += 2) {
        const int mm = lane >> 3;
        stmatrix_t(
            zs + s * SLICE + (c + (mm >> 1)) * 256 + (mm & 1) * 128 +
                (lane & 7) * 16,
            bits2(__floats2bfloat162_rn(acc[m][4 * c], acc[m][4 * c + 1])),
            bits2(__floats2bfloat162_rn(acc[m][4 * c + 2], acc[m][4 * c + 3])),
            bits2(__floats2bfloat162_rn(acc[m][4 * c + 4], acc[m][4 * c + 5])),
            bits2(__floats2bfloat162_rn(acc[m][4 * c + 6], acc[m][4 * c + 7])));
      }
    }
    fence_proxy_async();        // wgmma reads what stmatrix wrote
    consumers_sync();
    RHT_STAMP(5);

    // Y[p][q] = T(sum_i Lop[p][i] Z[i][q])
    float acc2[MT][16];
    const uint32_t ls = smem_u32(Ls);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
      for (int s = 0; s < G.ks2; ++s)
        wgmma_ss(acc2[m], desc_plain(ls + s * MT * 2048 + m * 2048, 128),
                 desc_plain(zs + s * SLICE, 128), s > 0);
    wgmma_commit();
    // the transpose's vec at this lane's outputs (p, 8 c + 2 t of the
    // block's slice; rows past a read row a - 1 and are not stored), read
    // while Y's products run
    uint32_t ve[MT][NQ / 8][2];
    if (transpose) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < NQ / 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = min(64 * m + 16 * w + g + 8 * h, a - 1);
            ve[m][c][h] = *reinterpret_cast<const uint32_t*>(
                Vs + p * VLD + 8 * c + 2 * t);
          }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) pin(acc2[m][e]);
    RHT_STAMP(6);

    // y[p][q]: acc2[m][4 c + 2 h + e] is (p, q + e); each store predicated,
    // not branched around
    __nv_bfloat16* yr = y + (size_t)row * n;
    uint32_t yv[MT][NQ / 8][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < NQ / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc2[m][4 * c + 2 * h],
                                                   acc2[m][4 * c + 2 * h + 1]);
          if (transpose) v = __hmul2(v, bf2(ve[m][c][h]));
          yv[m][c][h] = bits2(v);
        }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < NQ / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 64 * m + 16 * w + g + 8 * h, q = q0 + 8 * c + 2 * t;
          const bool in = p < a && q < b;
          unsigned short* at =
              reinterpret_cast<unsigned short*>(yr + (size_t)p * b + q);
          if (even) {
            if (in) *reinterpret_cast<uint32_t*>(at) = yv[m][c][h];
          } else {
            if (in) at[0] = (unsigned short)yv[m][c][h];
            if (in && q + 1 < b) at[1] = (unsigned short)(yv[m][c][h] >> 16);
          }
        }
    RHT_STAMP(7);
  }
}

__global__ void empty_kernel() {}

template <int MT, int NB>
cudaError_t run_mma(const __nv_bfloat16* x, int B, int a, int b,
                    const __nv_bfloat16* vp, const __nv_bfloat16* lp,
                    const __nv_bfloat16* rp, int transpose,
                    __nv_bfloat16* y, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rht_mma<MT, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const Geo G = geo(a, b, transpose);
  if (G.bytes > kMmaSmem || B > 65535) return cudaErrorInvalidValue;
  const int flat =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && (a * b) % 8 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G.nq, B);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = G.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rht_mma<MT, NB>, x, vp, lp, rp, y, a, b,
                            transpose, flat);
}

template <int MT>
cudaError_t run_mma_nb(int nb, const __nv_bfloat16* x, int B, int a, int b,
                       const __nv_bfloat16* vp, const __nv_bfloat16* lp,
                       const __nv_bfloat16* rp, int transpose,
                       __nv_bfloat16* y, cudaStream_t s) {
  switch (nb) {
    case 1: return run_mma<MT, 1>(x, B, a, b, vp, lp, rp, transpose, y, s);
    case 2: return run_mma<MT, 2>(x, B, a, b, vp, lp, rp, transpose, y, s);
    case 3: return run_mma<MT, 3>(x, B, a, b, vp, lp, rp, transpose, y, s);
    case 4: return run_mma<MT, 4>(x, B, a, b, vp, lp, rp, transpose, y, s);
  }
  return cudaErrorInvalidValue;
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
// refuses shapes above what a block can have.
extern "C" long long quip_rht_smem_bytes(int is_bf16, int a, int b,
                                         int has_right, int transpose) {
  if (is_bf16) return (long long)geo(a, b, transpose).bytes;
  return (long long)(smem_floats(a, has_right ? (b + 3) / 4 * 4 : 0) *
                     sizeof(float));
}

// The f32 kernel: x, y (B, a*b) f32; vec (a*b,), L (a, a), R (b, b) f32, R
// null when b == 1. Returns the CUDA error code (0 = success).
extern "C" int quip_rht_apply(const void* x, int B, int a, int b,
                              const void* vec, const void* L, const void* R,
                              int transpose, void* y, void* stream) {
  const float* r = static_cast<const float*>(R);
  if (B < 1 || a < 1 || b < 1 || (r == nullptr && b != 1))
    return (int)cudaErrorInvalidValue;
  return (int)run<float>(static_cast<const float*>(x), B, a, b,
                         static_cast<const float*>(vec),
                         static_cast<const float*>(L), r, transpose,
                         static_cast<float*>(y),
                         static_cast<cudaStream_t>(stream));
}

// The bf16 kernel: x, y (B, a*b) bf16, x 16-byte aligned; vec, L, R the
// prepared bf16 operands of kernels/rht.py::prepare (b == 1: R is the 1 x 1
// identity); 1 <= a <= 128, 1 <= b <= 256.
extern "C" int quip_rht_apply_bf16(const void* x, int B, int a, int b,
                                   const void* vec, const void* L,
                                   const void* R, int transpose, void* y,
                                   void* stream) {
  if (B < 1 || a < 1 || b < 1 || a > 128 || b > 256)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(vec);
  const __nv_bfloat16* lb = static_cast<const __nv_bfloat16*>(L);
  const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(R);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = geo(a, b, transpose).nb;
  const cudaError_t e =
      a > 64 ? run_mma_nb<2>(nb, xb, B, a, b, vb, lb, rb, transpose, yb, s)
             : run_mma_nb<1>(nb, xb, B, a, b, vb, lb, rb, transpose, yb, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing: the floor under any kernel's time
// when launches are replayed from a CUDA graph.
extern "C" int quip_rht_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
