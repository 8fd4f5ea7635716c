// K1': packed dequant-matmul by the slab-dot route (qfn-b) for Hopper
// (sm_90a): y = s . ((2/maxq) . (bf16(x) . codes^T) - sum(bf16(x))).
//
// Replaces the Pallas kernel scripts/bench_kernel.py (slabdot_matmul ->
// _slabdot_kernel), the microbenchmark's variant of K1. The function is
// K1's for qfn-b; the arithmetic is the variant's own and stays so:
//   * field k of a plane's words becomes a slab of bf16 values 128 + c by
//     shifting the field down, masking it in both half-words and OR-ing
//     0x43004300 (bf16 0x4300 = 128; a code fills the low mantissa bits
//     exactly): one shift and one lop3 per field, no convert;
//   * each slab is dotted against its contiguous x chunk
//     x[:, k.2nw : (k+1).2nw] (field k meets x's columns k.2nw + 2j + h)
//     with f32 accumulation;
//   * the 128 offset leaves once per plane, as -128 . sum(bf16(x)) in f32,
//     then the plane weights and the qfn-b affine map apply.
// K1 subtracts the offset exactly per element; this variant pays f32 digits
// for it (sums of magnitude 128 . |x| . sqrt(d)), which is why its limit
// against K1 is 2e-2 of max |y|; against its plain version
// (kernels/slabdot.py::slabdot_matmul_ref) it is 1e-3: the same arithmetic
// in another summation order.
//
// Bound on this card: the packed planes' bytes (the five 2-bit Llama-2-7B
// shapes of the microbenchmark: 84 MB, 0.0249 ms at 3.35 TB/s). A 4 KB
// group of 2-bit words (8 word rows by 128 columns) takes 16 wgmma, 1024
// words x 8 fields of unpack and 4 KB of copies; each alone is near an
// SM's share of the memory rate, so they must overlap:
//   * the products are wgmma.m64n8k16 with the rows of x as the narrow
//     side: D (64 output columns x 8 rows of x, f32 in registers) += A (64
//     columns x 16 fan-in columns: the masked slab, in registers) . B (16
//     fan-in columns x 8 rows, bf16(x)^T in shared memory in wgmma's
//     K-major core-matrix layout, read through a descriptor). A lane (g =
//     lane / 4, t = lane % 4) of warp w holds A rows 16w + g and
//     16w + g + 8 at k pairs (2t, 2t+1) and (2t+8, 2t+9): for field k and
//     word rows j0..j0+7 the field of words (j0 + t, column) and
//     (j0 + t + 4, column), one masked word one A register. A row r of
//     m-tile mt is output column 32w + 4(r % 8) + 2mt + r / 8 of the
//     warpgroup's 128, so the four words a lane needs of a word row are
//     one 16-byte read: the A registers of both m-tiles;
//   * unpack overlapped with the products (decode_common.cuh's
//     consume_plane, the walk K1-decode runs with runs of 7 / FB fields,
//     here with runs of one): a warpgroup unpacks a batch of 2 fields into
//     one of two register sets while the wgmma of the batch before read
//     the other (fence, the batch's 4 wgmma, commit, wait_group 1 before
//     that set is written again). Each plane of a format has accumulators
//     of its own, in two sets that the batches take in turn, and the
//     format is a template argument of the kernel, so no write to the
//     accumulators lies between two walks of wgmma (ptxas would serialise
//     them: C7513 / C7515). One set ran as fast on the 2-bit shapes but
//     spilled in the 3-bit instance at two blocks an SM;
//   * two blocks an SM (their registers: up to 168 a thread, no spill;
//     capped for three, ptxas spills and the shapes ran no faster), the
//     plan's fan-in splits filling about that many;
//   * the copies: one consumer warpgroup a block and one producer warp,
//     whose lane 0 issues one TMA box a slot (128 + 8 columns by 8 GPS word
//     rows, through a tensor map of the plane made on the host) into a ring
//     of STAGES slots, each guarded by a "full" mbarrier (transaction
//     bytes) and an "empty" one (the consumer warps, which read their words
//     into registers and free the slot at once). The 8 spare columns keep
//     the rows 136 words apart, so a quarter-warp's 16-byte reads fall into
//     8 different bank groups;
//   * a block (the blocks of one cluster) owns tile_m output columns, the
//     argument the microbenchmark sweeps: it walks them 128 columns at a
//     time, both planes of a column group in turn, and the producer runs
//     straight on into the next group;
//   * ONE launch a call, no scratch, no atomics: the fan-in splits of a
//     column block are the blocks of one thread-block cluster (at most 8).
//     Each leaves its f32 partials (the planes weighted and added) in its
//     shared memory; after a cluster barrier block `split` adds its share
//     of the outputs over the splits through distributed shared memory in
//     split order (the same bits every run), takes 128 . sum_p pw_p .
//     sum(x) off and applies the qfn-b map. When the partials of min(B, 8)
//     rows x tile_m columns exceed 32 KB, the column groups go in chunks
//     with a barrier pair each; the producer keeps a ring's worth of the
//     next chunk in flight across the barriers;
//   * programmatic dependent launch: the barriers, the tensor-map prefetch
//     and the first ring slots of planes (weights: nothing earlier writes
//     them) run before griddepcontrol.wait; x's staging and every global
//     store after it. The producer lets the next grid launch once its last
//     plane copy is issued, the consumers once their walk is done.
// What binds it (tools/tune_slabdot.py's ablation, PERF.md section 6): the
// unpack with the products. Copies alone take about two thirds of the
// kernel's time and the unpack without the products adds little to them;
// with the products, each ALU instruction of the unpack counts: two a
// field and A register (K1-decode's runs need 4 / 3) hold an SM's ALU pipe
// at about the memory rate, and the wgmma between them leave it idle.
// Ragged edges: word rows >= nw and columns >= m arrive as zero words (the
// tensor map's out-of-bounds fill); a zero word unpacks to 128 and meets x
// columns staged as zero past each field's span. Rows of x go in tiles of
// 8 (the grid's z); within a tile, rows >= B of a core matrix read what
// follows it, and their products land in columns of D that nobody stores.
// tile_m is a multiple of 128 that divides m, so every output column is
// real.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXB = 8;                 // rows of x a tile (wgmma's N)
constexpr int STAGES = 4;               // ring slots
constexpr int GPS = 2;                  // groups of 8 word rows a slot
constexpr int SROW = 136;               // a box row's stride in words
constexpr int CG = 128;                 // columns of a column group
constexpr int BOXW = 8 * GPS * SROW;    // words of a slot's box
constexpr int BOX_BYTES = 4 * BOXW;     // a multiple of 128
constexpr int NC = 128;                 // one consumer warpgroup
constexpr int NT = NC + 32;             // and one producer warp
constexpr int ASETS = 2;                // accumulator sets, batch by batch
constexpr int MIN_BLOCKS = 2;           // blocks an SM (registers)
constexpr int kMaxSmem = 220 * 1024;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// grid (m / tile_m, splits, ceil(B / 8)), NT threads, clusters of
// (1, splits, 1); FB0 / FB1 the planes' field widths (FB1 = 0: one
// plane). Dynamic shared memory from a 128-byte aligned base: the ring,
// the partials of min(B, 8) rows x chunk_cols columns (at the same offset
// in every block of the cluster: the others read it), then x staged once a
// distinct field width and 128 bytes that rows >= B of the last core
// matrix read. e128 = 0x43004300, 128 in both halves (see code_pair).
template <int FB0, int FB1>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
sd_kernel(const __grid_constant__ CUtensorMap map0,
          const __grid_constant__ CUtensorMap map1,
          const void* __restrict__ x, int is_bf16, int B, int d, float pw0,
          float pw1, int m, int tile_m, int chunk_cols, float maxq,
          const float* __restrict__ scale, void* __restrict__ out,
          uint32_t e128) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float sums[MAXB];     // this split's sum of bf16(x) a row
  __shared__ float xsum[MAXB];     // all splits', in split order
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b0 = blockIdx.z * MAXB, Bz = min(MAXB, B - b0);
  const int rows = min(MAXB, B);
  const int ncg = tile_m / CG, cpc = chunk_cols / CG;
  const int nchunks = (ncg + cpc - 1) / cpc;
  const int col0 = cb * tile_m;

  const Part pt[2] = {part_of(FB0, d, split, splits),
                      part_of(FB1 ? FB1 : FB0, d, split, splits)};
  // slots of a column group: plane 1 (the heavier) first, then plane 0
  const int n1 = FB1 ? (pt[1].ng + GPS - 1) / GPS : 0;
  const int spg = n1 + (pt[0].ng + GPS - 1) / GPS;
  const int total = ncg * spg;

  unsigned char* base = dsmem + ((128 - (smem_u32(dsmem) & 127)) & 127);
  uint32_t* ring = reinterpret_cast<uint32_t*>(base);
  float* red = reinterpret_cast<float*>(base + STAGES * BOX_BYTES);
  const int bp = pad_rows(Bz);
  // plane 1 shares plane 0's staged x when its fields are as wide
  unsigned char* xs[2];
  xs[0] = base + STAGES * BOX_BYTES + rows * chunk_cols * 4;
  xs[1] = FB1 && FB1 != FB0 ? xs[0] + x_bytes(pt[0].ng, FB0, bp) : xs[0];

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (warp == NC / 32) {
    // ---- producer: slot L = (column group L / spg, plane, slot) ----------
    if (lane == 0) {
      prefetch_tensormap(&map0);
      if (FB1) prefetch_tensormap(&map1);
    }
    int L = 0;
    for (int c = 0; c < nchunks; ++c) {
      // this chunk's slots and a ring's worth of the next one: they are
      // freed by slots the consumers finish before the barrier
      const int end = min(total, min(ncg, (c + 1) * cpc) * spg + STAGES);
      if (lane == 0)
        for (; L < end; ++L) {
          const int cgi = L / spg, r = L - cgi * spg;
          const int p = r < n1 ? 1 : 0, st = p ? r : r - n1;
          const int slot = L % STAGES;
          if (L >= STAGES) mbar_wait(&empty[slot], (L / STAGES - 1) & 1);
          mbar_expect_tx(&full[slot], BOX_BYTES);
          tma_load(ring + slot * BOXW, p ? &map1 : &map0, col0 + cgi * CG,
                   8 * (pt[p].rg0 + GPS * st), &full[slot]);
        }
      __syncwarp();
      if (c == nchunks - 1) grid_dep_launch();   // the last copy is issued
      cluster.sync();      // the consumers' partials of chunk c are written
      cluster.sync();      // chunk c is reduced: the partials may be reused
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  grid_dep_wait();                       // x and out belong to earlier grids
  const void* xz = static_cast<const unsigned char*>(x) +
                   (size_t)b0 * d * (is_bf16 ? 2 : 4);
  const bool two = xs[1] != xs[0];
  if (x_async(is_bf16, pt[0]) && (!two || x_async(is_bf16, pt[1]))) {
    stage_issue<NC>(xs[0], bp, xz, Bz, d, pt[0], tid);
    if (two) stage_issue<NC>(xs[1], bp, xz, Bz, d, pt[1], tid);
    cp_async_wait_all();
  } else {
    stage_x<NC>(xs[0], bp, xz, is_bf16, Bz, d, pt[0], tid);
    if (two) stage_x<NC>(xs[1], bp, xz, is_bf16, Bz, d, pt[1], tid);
  }
  fence_proxy_async();                   // wgmma reads what was stored
  consumers_sync();
  part_sums(xs[0], bp, pt[0], 1, Bz, warp, NC / 32, lane, 0.f, true, sums,
            nullptr);

  const int g = lane >> 2, t = lane & 3;
  const uint32_t* ws = ring + t * SROW + 32 * warp + 4 * g;
  const float pwsum = pw0 + (FB1 ? pw1 : 0.f);
  const float s0 = scale[0], two_q = 2.0f / maxq;
  int it = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int cg0 = c * cpc, cg1 = min(ncg, cg0 + cpc);
    for (int cgi = cg0; cgi < cg1; ++cgi) {
      float y[2][4];
      walk_planes<FB0, FB1, false, STAGES, GPS, SROW, ASETS>(
          y, pt, xs, bp, it, ws, BOXW, full, empty, pw0, pw1,
          lane, e128);
      // a lane holds, for rows 2t and 2t + 1 of x, the columns 4g .. 4g + 3
      // of its warp's 32: m-tile mt gives 4g + 2mt (d0, d1) and
      // 4g + 2mt + 1 (d2, d3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 2 * t + h;
        if (b < Bz)
          *reinterpret_cast<float4*>(red + b * chunk_cols + (cgi - cg0) * CG +
                                     32 * warp + 4 * g) =
              make_float4(y[0][h], y[0][2 + h], y[1][h], y[1][2 + h]);
      }
    }
    if (c == nchunks - 1) grid_dep_launch();     // the walk is done
    cluster.sync();
    if (c == 0) {
      if (tid < Bz) {
        float s = 0.f;
        for (int y = 0; y < splits; ++y)
          s += *cluster.map_shared_rank(sums + tid, y);
        xsum[tid] = s;
      }
      consumers_sync();
    }
    // split `split` finishes its share of the chunk's Bz x ccols outputs
    const int q4 = (cg1 - cg0) * CG / 4, all = Bz * q4;
    const int e_end = all * (split + 1) / splits;
    for (int e = all * split / splits + tid; e < e_end; e += NC) {
      const int b = e / q4, cc = (e - b * q4) * 4;
      const float4 pv = split_sum4(cluster, red, b * chunk_cols + cc, splits);
      float v[4] = {pv.x, pv.y, pv.z, pv.w};
      const float xb = xsum[b], off = 128.f * pwsum * xb;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s0 * (two_q * (v[j] - off) - xb);
      const size_t at = (size_t)(b0 + b) * m + col0 + cg0 * CG + cc;
      if (is_bf16)
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    cluster.sync();
  }
}

// the plane formats of pack/format.py's PLANE_SPLITS
bool format_ok(int fb0, int fb1, int nplanes) {
  return nplanes == 1 ? fb0 == 2 || fb0 == 4
                      : nplanes == 2 && ((fb0 == 2 && fb1 == 1) ||
                                         (fb0 == 4 && fb1 == 4));
}

// dynamic shared memory of a launch: 128 bytes of alignment slack, the
// ring, the partials, x's staged parts for the widest split (once a
// distinct field width) and 128 bytes past them
size_t smem_bytes(int B, int d, int fb0, int fb1, int nplanes, int splits,
                  int chunk_cols) {
  const int rows = B < MAXB ? B : MAXB;
  size_t s = 128 + (size_t)STAGES * BOX_BYTES + (size_t)rows * chunk_cols * 4 +
             128;
  for (int p = 0; p < nplanes; ++p) {
    const int fb = p ? fb1 : fb0;
    if (p == 1 && fb1 == fb0) break;
    const int NG = (d * fb / 32 + 7) / 8;
    s += x_bytes((NG + splits - 1) / splits, fb, pad_rows(rows));
  }
  return s;
}

// The (nw, m) plane of 32-bit words as a 2-D tensor map with boxes of
// SROW columns by 8 GPS word rows, out-of-bounds words zero.
bool plane_map(CUtensorMap* map, const void* plane, int nw, int m) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)nw};
  const cuuint64_t strides[1] = {(cuuint64_t)m * 4};
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
  const void *plane0, *plane1;
  int fb0, fb1, nplanes;
  float pw0, pw1;
  int m, tile_m, splits, chunk_cols;
  float maxq;
  const float* scale;
};

template <int FB0, int FB1>
cudaError_t run(const Args& a, size_t smem, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sd_kernel<FB0, FB1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap map0 = {}, map1 = {};
  if (!plane_map(&map0, a.plane0, a.d * FB0 / 32, a.m) ||
      !plane_map(&map1, FB1 ? a.plane1 : a.plane0,
                 a.d * (FB1 ? FB1 : FB0) / 32, a.m))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.m / a.tile_m, a.splits, (a.B + MAXB - 1) / MAXB);
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
  return cudaLaunchKernelEx(&cfg, sd_kernel<FB0, FB1>, map0, map1, a.x,
                            a.is_bf16, a.B, a.d, a.pw0, a.pw1, a.m, a.tile_m,
                            a.chunk_cols, a.maxq, a.scale, a.out,
                            0x43004300u);
}

}  // namespace

// x (B, d) and out (B, m) share one dtype: bf16 (is_bf16 = 1) or f32 (x is
// rounded to bf16 inside either way); x 32-byte aligned. planes: int32
// (d*fb/32, m) each, 16-byte aligned, as PLANE_SPLITS lays out 2, 3
// (2 + 1), 4 and 8 (4 + 4) bits. tile_m: a multiple of 128 that divides
// m. 1 <= splits <= 8 parts of the fan-in (the blocks of one cluster), at
// most the groups of 8 word rows of the shortest plane. chunk_cols: a
// multiple of 128, the columns whose partials one barrier pair reduces.
// scale -> one f32 (device). Returns the CUDA error code (0 = success).
extern "C" int quip_slabdot_matmul(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m,
    int tile_m, int splits, int chunk_cols, float maxq, const void* scale,
    void* out, void* stream) {
  if (!format_ok(fb0, fb1, nplanes) || B < 1 || d < 32 || d % 32 != 0 ||
      tile_m < CG || tile_m % CG != 0 || m % tile_m != 0 || splits < 1 ||
      splits > 8 || chunk_cols < CG || chunk_cols % CG != 0)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < nplanes; ++p)
    if (splits > (d * (p ? fb1 : fb0) / 32 + 7) / 8)
      return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(B, d, fb0, fb1, nplanes, splits, chunk_cols);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.out = out;
  a.is_bf16 = is_bf16;
  a.B = B;
  a.d = d;
  a.plane0 = plane0;
  a.plane1 = plane1;
  a.fb0 = fb0;
  a.fb1 = fb1;
  a.nplanes = nplanes;
  a.pw0 = pw0;
  a.pw1 = pw1;
  a.m = m;
  a.tile_m = tile_m;
  a.splits = splits;
  a.chunk_cols = chunk_cols;
  a.maxq = maxq;
  a.scale = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the format, dispatched once, outside the walk
  const int fmt = nplanes > 1 ? 10 * fb0 + fb1 : fb0;
  const cudaError_t e = fmt == 2    ? run<2, 0>(a, smem, s)
                        : fmt == 4  ? run<4, 0>(a, smem, s)
                        : fmt == 21 ? run<2, 1>(a, smem, s)
                                    : run<4, 4>(a, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
