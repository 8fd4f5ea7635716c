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
//     other (decode_common.cuh's consume_plane, which K1' runs too): fence, the batch's 4 wgmma, commit, then wait_group 1 retires
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

constexpr int NWG = 2;                  // consumer warpgroups a block
constexpr int NC = 128 * NWG;           // consumer threads
constexpr int NT = NC + 32;             // and one producer warp
constexpr int BN = 128 * NWG;           // output columns of a block

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// 4-byte copy global -> shared, zero-filled when !ok (cp.async)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
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
      part_sums(xs[p], bp, pt[p], 7 / pt[p].fb, B, warp, NC / 32, lane,
                p ? pw1 : pw0, p == 0, sums, sums + MAXB);

    const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const uint32_t* ws = ring + c * BOXW + t * SROW + 32 * w + 4 * g;
    float y[2][4];
    // the formats of PLANE_SPLITS: 2 / 4 bits, 2 + 1 and 4 + 4
    const int fmt = nplanes > 1 ? 10 * fb0 + fb1 : fb0;
    int it = 0;
    if (fmt == 2)
      walk_planes<2, 0, true, STAGES, GPS, SROW, 1>(
          y, pt, xs, bp, it, ws, NWG * BOXW, full, empty, pw0, pw1,
          lane, e128);
    else if (fmt == 4)
      walk_planes<4, 0, true, STAGES, GPS, SROW, 1>(
          y, pt, xs, bp, it, ws, NWG * BOXW, full, empty, pw0, pw1,
          lane, e128);
    else if (fmt == 21)
      walk_planes<2, 1, true, STAGES, GPS, SROW, 1>(
          y, pt, xs, bp, it, ws, NWG * BOXW, full, empty, pw0, pw1,
          lane, e128);
    else
      walk_planes<4, 4, true, STAGES, GPS, SROW, 1>(
          y, pt, xs, bp, it, ws, NWG * BOXW, full, empty, pw0, pw1,
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
