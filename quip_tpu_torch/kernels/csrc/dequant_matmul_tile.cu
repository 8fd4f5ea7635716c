// K1-tile: packed dequant-matmul on the tensor cores for Hopper (sm_90a),
// the batched path (B > 8 rows) of y = bf16(x) . dequant(planes)^T.
//
// Replaces, with dequant_matmul.cu (the single-row path), the Pallas kernel
// quip_tpu/kernels/dequant_matmul.py (_dequant_matmul_local -> _kernel /
// _plane_codes_dot). Same semantics: x rounded to bf16, f32 accumulation,
// planes as pack/format.py lays them out (word (j, i), field k, half h =
// code of output column i at fan-in column k*2nw + 2j + h), plane weights,
// qfn-b / qfn-a affine fixups with the sum of bf16(x).
//
// Bound on this card: above a few hundred rows the products (989 TFLOP/s
// bf16), below that the planes' bytes. Design:
//   * mma.sync.m16n8k16 (bf16 -> f32), not wgmma: the plane layout already
//     is an mma B fragment. For the 16-deep slice "field k, word rows
//     j0..j0+7, both halves" a lane (g = lane / 4, t = lane % 4) needs
//     B[2t, 2t+1][g] and B[2t+8, 2t+9][g]: the two halves of field k of word
//     (j0 + t, column g) and of word (j0 + t + 4, column g). So
//     ((w >> FB*k) & MASK*0x00010001) | 0x43004300 is the register holding
//     two bf16 values 128 + c, and one sub.bf16x2 takes the 128 out exactly
//     (c <= 15). The matching A slice is 16 contiguous columns of x at
//     k*2nw + 2*j0. One 32-bit word feeds 16/FB mma operands and the
//     unpacked W never touches shared memory; wgmma would need it staged
//     there in the swizzled layout.
//   * a warp owns 32 output columns as four n-tiles interleaved by 4
//     (n-tile q, index g = column 4g + q): a lane's four words of one word
//     row are one 16-byte load, and its 8 outputs of a row are contiguous.
//   * a block owns BM (16, 32 or 64) rows of x and 32 columns per warp (4
//     or 8 warps side by side) and walks the fan-in in stages of 8 slices
//     (128 columns of x). A stage's x tile (bf16) and plane words go to
//     shared memory by
//     16-byte cp.async, three or four stages deep; A fragments come by
//     ldmatrix from rows padded to 272 bytes (conflict-free), the words by
//     one 16-byte read per lane and word row from rows padded by 32 bytes.
//     Each plane word is read and unpacked once per BM rows.
//   * planes of a multi-plane width run one after the other into the same
//     accumulators (heavier plane first, then acc *= its weight).
//   * few rows leave few blocks: the fan-in then splits over grid.z, f32
//     partials go to scratch and a second kernel adds them and applies the
//     fixup. With one split the fixup is the epilogue of the tile kernel.
//   * a small kernel ahead sums bf16(x) per row and, for f32 x, writes the
//     bf16 copy the tile kernel stages.
// Ragged edges are masked here: rows >= B and x columns past a field's span
// are zero-filled, word rows >= nw and columns >= m_p read as zero words
// (code 0 after the subtraction). The wrapper guarantees nw % 4 == 0 for
// every plane and m_p % 8 == 0 (16-byte alignment of every copy).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KC = 128;       // fan-in columns per stage: 8 slices of 16
constexpr int AS = KC + 8;    // x row stride in shared memory, in bf16
constexpr int WPAD = 8;       // word row pad, in words

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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// field at bit `sh` of both half-words -> two exact bf16 codes
template <uint32_t MP>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int sh) {
  uint32_t v = ((w >> sh) & MP) | 0x43004300u;
  const uint32_t magic = 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__host__ __device__ constexpr int stages_for(int fb) { return fb == 4 ? 3 : 4; }
__host__ __device__ constexpr int rgs_for(int fb) { return fb == 4 ? 2 : 1; }
__host__ __device__ constexpr int stage_bytes(int bm, int bn, int fb) {
  return bm * AS * 2 + rgs_for(fb) * 8 * (bn + WPAD) * 4;
}
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  const int a = stages_for(2) * stage_bytes(bm, bn, 2);
  const int b = stages_for(4) * stage_bytes(bm, bn, 4);
  return a > b ? a : b;
}

// Block shape: WN warps side by side, each MT m-tiles of 16 rows by 32
// columns (4 n-tiles of 8, interleaved by 4).
template <int MT_, int WN_>
struct Shape {
  static constexpr int MT = MT_, WN = WN_;
  static constexpr int BM = 16 * MT;
  static constexpr int BN = 32 * WN;
  static constexpr int NT = 32 * WN;               // threads
  static constexpr int SMEM = smem_bytes(BM, BN);
};

// One plane of FB-bit fields, stages [split, split + 1) / splits of its
// fan-in, accumulated into acc (x . codes^T, unweighted).
template <typename SH, int FB>
__device__ __forceinline__ void run_plane(
    float (&acc)[SH::MT][4][4], const __nv_bfloat16* __restrict__ x,
    int B, int d, int b0, const uint32_t* __restrict__ plane, int m_p,
    int n_blk0, int split, int splits, unsigned char* smem) {
  constexpr int FPH = 16 / FB;           // fields per half-word
  constexpr int RG = rgs_for(FB);        // groups of 8 word rows per stage
  constexpr int STAGES = stages_for(FB);
  constexpr int BM = SH::BM, BN = SH::BN, NT = SH::NT;
  constexpr int MT = SH::MT;
  constexpr int WS = BN + WPAD;
  constexpr int A_BYTES = BM * AS * 2;
  constexpr int STAGE_BYTES = stage_bytes(BM, BN, FB);
  constexpr uint32_t MP = ((1u << FB) - 1u) * 0x00010001u;

  const int nw = d * FB / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nslices = ((nw + 7) / 8) * FPH;
  const int ns_all = (nslices + 7) / 8;
  const int s_begin = (int)((long long)ns_all * split / splits);
  const int s_end = (int)((long long)ns_all * (split + 1) / splits);
  const int ns = s_end - s_begin;

  // slice L = 8 s + u is (row group L / FPH, field L % FPH): its x columns
  // are k*2nw + 16*rg + 0..15, its words rows 8*rg .. 8*rg + 7
  auto load_stage = [&](int s, int slot) {
    unsigned char* base = smem + slot * STAGE_BYTES;
    for (int e = tid; e < BM * 16; e += NT) {
      const int r = e >> 4, q = e & 15;
      const int L = s * 8 + (q >> 1);
      const int rg = L / FPH, k = L - rg * FPH;
      const int off = 16 * rg + 8 * (q & 1);
      const bool ok = (b0 + r < B) && (off < 2 * nw);
      const __nv_bfloat16* src =
          ok ? x + (size_t)(b0 + r) * d + (size_t)k * 2 * nw + off : x;
      cp_async16(smem_u32(base + (r * AS + q * 8) * 2), src, ok);
    }
    const int rg0 = (s * 8) / FPH;
    uint32_t* wb = reinterpret_cast<uint32_t*>(base + A_BYTES);
    for (int e = tid; e < RG * 8 * (BN / 4); e += NT) {
      const int r = e / (BN / 4), c = (e - r * (BN / 4)) * 4;
      const int j = rg0 * 8 + r, col = n_blk0 + c;
      const bool ok = (j < nw) && (col < m_p);
      const uint32_t* src = ok ? plane + (size_t)j * m_p + col : plane;
      cp_async16(smem_u32(wb + r * WS + c), src, ok);
    }
  };

  auto compute = [&](int s, int slot) {
    const unsigned char* base = smem + slot * STAGE_BYTES;
    const uint32_t a_base =
        smem_u32(base) + ((lane & 15) * AS + (lane >> 4) * 8) * 2;
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(base + A_BYTES);
    uint32_t w[RG][2][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            wb + (r * 8 + t + 4 * hh) * WS + warp * 32 + 4 * g);
        w[r][hh][0] = v.x;
        w[r][hh][1] = v.y;
        w[r][hh][2] = v.z;
        w[r][hh][3] = v.w;
      }
    const int sh0 = FB == 1 ? (s & 1) * 8 : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = FB == 4 ? (u >> 2) : 0;
      const int sh = sh0 + FB * (FB == 4 ? (u & 3) : u);
      uint32_t bf[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf[q][0] = code_pair<MP>(w[r][0][q], sh);
        bf[q][1] = code_pair<MP>(w[r][1][q], sh);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + (mt * 16 * AS + u * 16) * 2);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16(acc[mt][q], a, bf[q][0], bf[q][1]);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) load_stage(s_begin + i, i);
    cp_async_commit();
  }
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // stage `it` landed; slot of `it - 1` is free
    const int nx = it + STAGES - 1;
    if (nx < ns) load_stage(s_begin + nx, nx % STAGES);
    cp_async_commit();
    compute(s_begin + it, it % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();            // the next plane reuses the ring
}

__device__ __forceinline__ float fixup(float ycodes, float xsum, int i,
                                       int qfn_b, float maxq,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ zero) {
  if (qfn_b) return scale[0] * ((2.0f / maxq) * ycodes - xsum);
  return scale[i] * ycodes - scale[i] * zero[i] * xsum;
}

// grid (ceil(B / BM), ceil(m_p / BN), splits). x: bf16 (B, d).
// splits == 1: out (B, m_p) gets the finished values (bf16 or f32);
// otherwise partial (splits, B, m_p) gets the weighted code products.
template <typename SH>
__global__ void __launch_bounds__(SH::NT, SH::BM == 64 ? 2 : 1)
dm_tile(const __nv_bfloat16* __restrict__ x, int B, int d,
        const uint32_t* __restrict__ plane0, int fb0,
        const uint32_t* __restrict__ plane1, int fb1, int nplanes, float pw0,
        float pw1, int m_p, int splits, const float* __restrict__ xsum,
        float* __restrict__ partial, int qfn_b, float maxq,
        const float* __restrict__ scale, const float* __restrict__ zero,
        void* __restrict__ out, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int MT = SH::MT;
  const int b0 = blockIdx.x * SH::BM;
  const int n_blk0 = blockIdx.y * SH::BN;
  const int split = blockIdx.z;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;

  for (int p = nplanes - 1; p >= 0; --p) {
    const uint32_t* plane = p ? plane1 : plane0;
    switch (p ? fb1 : fb0) {
      case 1:
        run_plane<SH, 1>(acc, x, B, d, b0, plane, m_p, n_blk0, split, splits,
                         smem);
        break;
      case 2:
        run_plane<SH, 2>(acc, x, B, d, b0, plane, m_p, n_blk0, split, splits,
                         smem);
        break;
      default:
        run_plane<SH, 4>(acc, x, B, d, b0, plane, m_p, n_blk0, split, splits,
                         smem);
        break;
    }
    // sum_p pw_p S_p = pw0 (S0 + (pw1 / pw0) S1)
    const float f = p ? pw1 / pw0 : pw0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] *= f;
  }

  // a lane holds, for rows g and g + 8 of each m-tile, the 8 contiguous
  // columns 8t .. 8t+7 of its warp's 32: n-tile q gives 8t + q and 8t+4+q
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = n_blk0 + warp * 32 + 8 * t;
  if (col >= m_p) return;     // m_p % 8 == 0: all 8 columns in or out
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + mt * 16 + g + 8 * half;
      if (b >= B) continue;
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[mt][q][2 * half];
        v[4 + q] = acc[mt][q][2 * half + 1];
      }
      if (splits > 1) {
        float4* dst = reinterpret_cast<float4*>(
            partial + ((size_t)split * B + b) * m_p + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
      const float xs = xsum[b];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = fixup(v[j], xs, col + j, qfn_b, maxq, scale, zero);
      if (out_bf16) {
        uint4 pk;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                  (size_t)b * m_p + col) = pk;
      } else {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) +
                                                (size_t)b * m_p + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

// One thread per (b, i): add the split partials and apply the fixup.
__global__ void dm_tile_finish(const float* __restrict__ partial, int splits,
                               int B, int m_p, const float* __restrict__ xsum,
                               int qfn_b, float maxq,
                               const float* __restrict__ scale,
                               const float* __restrict__ zero,
                               void* __restrict__ out, int out_bf16) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)B * m_p;
  if (idx >= n) return;
  const int b = (int)(idx / m_p);
  const int i = (int)(idx - (size_t)b * m_p);
  float s = 0.f;
  for (int y = 0; y < splits; ++y) s += partial[(size_t)y * n + idx];
  const float v = fixup(s, xsum[b], i, qfn_b, maxq, scale, zero);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[idx] = v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One block per row: xsum[b] = sum of bf16(x[b, :]); xb (when not null)
// gets the bf16 copy of an f32 x.
template <typename T>
__global__ void __launch_bounds__(256)
dm_prep(const T* __restrict__ x, int d, __nv_bfloat16* __restrict__ xb,
        float* __restrict__ xsum) {
  __shared__ float red[8];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += 256) {
    const __nv_bfloat16 h = __float2bfloat16_rn(to_f32(x[(size_t)b * d + c]));
    if (xb != nullptr) xb[(size_t)b * d + c] = h;
    s += __bfloat162float(h);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i];
    xsum[b] = tot;
  }
}

struct Args {
  const __nv_bfloat16* x;
  int B, d;
  const uint32_t *plane0, *plane1;
  int fb0, fb1, nplanes;
  float pw0, pw1;
  int m_p, splits;
  const float* xsum;
  float* partial;
  int qfn_b;
  float maxq;
  const float *scale, *zero;
  void* out;
  int out_bf16;
};

template <typename SH>
cudaError_t launch_tile(const Args& a, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dm_tile<SH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.B + SH::BM - 1) / SH::BM, (a.m_p + SH::BN - 1) / SH::BN,
            a.splits);
  dm_tile<SH><<<grid, SH::NT, SH::SMEM, s>>>(
      a.x, a.B, a.d, a.plane0, a.fb0, a.plane1, a.fb1, a.nplanes, a.pw0,
      a.pw1, a.m_p, a.splits, a.xsum, a.partial, a.qfn_b, a.maxq, a.scale,
      a.zero, a.out, a.out_bf16);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_rows(int nwarps, const Args& a, cudaStream_t s) {
  if (nwarps == 8) return launch_tile<Shape<MT, 8>>(a, s);
  if (nwarps == 4) return launch_tile<Shape<MT, 4>>(a, s);
  return cudaErrorInvalidValue;
}

bool fb_ok(int fb) { return fb == 1 || fb == 2 || fb == 4; }

}  // namespace

// x (B, d) and out (B, m_p) share one dtype: bf16 (is_bf16 = 1) or f32.
// planes: int32 (d*fb/32, m_p) each, d*fb % 128 == 0, m_p % 8 == 0.
// bm: rows per block in {16, 32, 64}; nwarps in {4, 8} (32 columns each);
// splits >= 1 parts of the fan-in. xb: bf16 (B, d) scratch, used when x is
// f32. work: f32 scratch of B rounded up to 4 (+ splits*B*m_p when
// splits > 1), 16-byte aligned. qfn-b:
// scale -> one f32 (device); qfn-a: scale, zero -> (m_p,) f32.
// Returns the CUDA error code (0 = success).
extern "C" int quip_dequant_matmul_tile(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m_p,
    int bm, int nwarps, int splits, void* xb, void* work, int qfn_b,
    float maxq, const void* scale, const void* zero, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > 2 || !fb_ok(fb0) || (nplanes == 2 && !fb_ok(fb1)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || splits < 1 || m_p % 8 != 0 || (d * fb0) % 128 != 0 ||
      (nplanes == 2 && (d * fb1) % 128 != 0))
    return (int)cudaErrorInvalidValue;
  float* xsum = static_cast<float*>(work);
  __nv_bfloat16* xbf = static_cast<__nv_bfloat16*>(xb);
  if (is_bf16) {
    dm_prep<__nv_bfloat16><<<B, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), d, nullptr, xsum);
  } else {
    dm_prep<float><<<B, 256, 0, s>>>(static_cast<const float*>(x), d, xbf,
                                     xsum);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Args a;
  a.x = is_bf16 ? static_cast<const __nv_bfloat16*>(x) : xbf;
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
  a.xsum = xsum;
  a.partial = xsum + ((B + 3) & ~3);      // 16-byte aligned
  a.qfn_b = qfn_b;
  a.maxq = maxq;
  a.scale = static_cast<const float*>(scale);
  a.zero = static_cast<const float*>(zero);
  a.out = out;
  a.out_bf16 = is_bf16;
  switch (bm) {
    case 16: e = launch_rows<1>(nwarps, a, s); break;
    case 32: e = launch_rows<2>(nwarps, a, s); break;
    case 64: e = launch_rows<4>(nwarps, a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)B * m_p;
  dm_tile_finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      a.partial, splits, B, m_p, xsum, qfn_b, maxq, a.scale, a.zero, out,
      is_bf16);
  return (int)cudaGetLastError();
}
