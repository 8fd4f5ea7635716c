// K1-tile: packed dequant-matmul on the tensor cores for Hopper (sm_90a),
// the batched path (B >= 9 rows) of y = bf16(x) . dequant(planes)^T.
//
// Replaces, with dequant_matmul_decode.cu (the path of 1 to 8 rows), the
// Pallas kernel quip_tpu/kernels/dequant_matmul.py (_dequant_matmul_local
// -> _kernel / _plane_codes_dot). Same function: x rounded to bf16, f32
// accumulation, planes as pack/format.py lays them out (word (j, i), field
// k, half h = code of output column i at fan-in column k*2nw + 2j + h),
// plane weights, qfn-b / qfn-a affine fix-ups with the sum of bf16(x).
//
// Bound on this card: above a few hundred rows the products (989 TFLOP/s
// bf16), below that the planes' bytes. Each output tile is computed
// transposed, y^T = W . x^T, on wgmma (the only instruction that reaches
// the card's full tensor-core rate):
//   * the dequantised weights are wgmma's A operand FROM REGISTERS
//     (m64nNk16, bf16 -> f32). A lane (g = lane / 4, t = lane % 4) of warp
//     w holds A rows 16w + g and 16w + g + 8 at k pairs (2t, 2t+1) and
//     (2t+8, 2t+9). For the 16-deep slice "field k, word rows j0..j0+7"
//     those are the two halves of field k of words (j0 + t, row) and
//     (j0 + t + 4, row): ((w >> FB*k) & MASK*0x00010001) | 0x43004300 is the
//     register holding two bf16 values 128 + c, and one sub.bf16x2 takes
//     the 128 out exactly (c <= 15). The unpacked W never touches shared
//     memory, and each unpacked register feeds an N-token product;
//   * rows of A map to output columns so that a lane's words of one word
//     row are one 16-byte read: warp w of consumer warpgroup c owns the 32
//     columns 128c + 32w + (0..31) of the block's 256; lane g's columns are
//     4g + q, q = 2 mt + h for A tile mt (two m64 tiles a warpgroup) and
//     row half h (row 16w + g + 8h of tile mt);
//   * x is the B operand, K-major in shared memory. Slice L = 8 s + u of a
//     plane is (word row group L / fph of 8 rows, field L % fph): one
//     stage s is one group of a 2-bit plane (all 8 fields), half a group
//     of a 1-bit plane, two groups of a 4-bit plane. A slice's 16 columns
//     of x (k*2nw + 16 rg ..) lie apart from the next slice's, so dm_prep
//     writes x in each plane's stage order (xp: columns 128 s .. of a
//     stage contiguous), and a stage's x is two TMA boxes of 64 columns by
//     N tokens with the 128-byte swizzle; slice u is box u / 4 at bytes
//     32 (u % 4) of its rows. (Boxes of one slice, 32-byte rows, moved the
//     same bytes at a fraction of the rate.)
//   * warp-specialised and persistent: one block an SM walks work items
//     (token tile, column tile, split); one producer warpgroup (one
//     thread issues the copies, setmaxnreg gives its registers away)
//     keeps a ring of STAGES slots full, each one stage's x boxes and the
//     word rows they read (one TMA box of 8 or 16 word rows by 256
//     columns), guarded by a "full" mbarrier (transaction bytes) and an
//     "empty" one (the 8 consumer warps), and runs on into the next item
//     while the consumers finish the last. Two consumer warpgroups read
//     their words from the slot, unpack them and issue the products in
//     batches of 4 slices;
//   * N (16 .. 128 tokens, multiples of 16) and the fan-in splits are the
//     wrapper's plan (kernels/dequant_matmul.py::_tile_plan); a block owns
//     256 output columns and N tokens, accumulator 2 x N/2 f32 a thread;
//   * planes of a multi-plane width run one after the other into the same
//     accumulators (heavier plane first, then acc *= its weight, after
//     wgmma.wait_group 0);
//   * the epilogue applies the fix-up and stores the tile, every load of
//     it ahead of the first store (staging it in shared memory for TMA
//     stores measured no faster); few rows leave few items: the fan-in
//     then splits, f32 partials go to scratch and a second kernel adds
//     them in split order and applies the fix-up;
//   * a small kernel ahead sums bf16(x) per row and writes xp.
// Ragged edges: TMA zero-fills rows of x >= B and word rows >= nw and
// columns >= m_p (zero words give code 0 after the subtraction); xp holds
// zeros past each field's span; rows >= B and columns >= m_p are not
// stored. The wrapper guarantees nw % 4 == 0 for every plane and m_p % 8
// == 0 (the tensor maps' 16-byte strides).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NCONS = 256;                 // consumer threads
constexpr int NT = NCONS + 128;            // and one producer warpgroup
constexpr int BN = 256;                    // output columns of a block
constexpr int WROW = 256;                  // words of a staged word row
constexpr int WBYTES = 16 * WROW * 4;      // words of a slot (<= 16 rows)
constexpr int kSmemBudget = 150 * 1024;   // the ring (tools/tune_tile.py)

__host__ __device__ constexpr int x_bytes(int n) { return 8 * n * 32; }
__host__ __device__ constexpr int slot_bytes(int n) {
  return x_bytes(n) + WBYTES;
}
__host__ __device__ constexpr int stages_for(int n) {
  return kSmemBudget / slot_bytes(n) < 8 ? kSmemBudget / slot_bytes(n) : 8;
}
__host__ __device__ constexpr int smem_for(int n) {
  return stages_for(n) * slot_bytes(n) + 1024;   // + alignment slack
}

// D (64 x N, f32) += A (64 x 16, bf16, registers) . B (16 x N, bf16, the
// descriptor's tile); one specialisation a token width, written out.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
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

// The stages [s0, s1) of one plane of FB-bit fields, from the ring, into
// acc (x . codes^T, unweighted). `it` counts the ring's stages (slot
// it % STAGES, parity (it / STAGES) & 1) across planes. col: this lane's
// first word column within the block's 256; t: its word row within 8.
// A stage is two batches of 4 slices: the batch's A registers are all
// unpacked before wgmma.fence opens it, and wgmma.wait_group 0 closes it,
// so no register a wgmma reads is written while one is in flight (ptxas
// would otherwise serialise every wgmma); the other consumer warpgroup's
// batch keeps the tensor cores busy meanwhile.
template <int N, int FB>
__device__ __forceinline__ void consume_plane(float (&acc)[2][N / 2], int s0,
                                              int s1, int& it,
                                              unsigned char* ring,
                                              uint64_t* full, uint64_t* empty,
                                              int col, int t, int lane) {
  constexpr int STAGES = stages_for(N);
  constexpr int RG = FB == 4 ? 2 : 1;     // groups of 8 word rows a stage
  constexpr uint32_t MP = ((1u << FB) - 1u) * 0x00010001u;
  for (int s = s0; s < s1; ++s, ++it) {
    const int slot = it % STAGES;
    mbar_wait(&full[slot], (it / STAGES) & 1);
    unsigned char* base = ring + slot * slot_bytes(N);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(base + x_bytes(N));
    uint32_t w[RG][2][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            ws + (8 * r + t + 4 * hh) * WROW + col);
        const int sh = FB == 1 ? 8 * (s & 1) : 0;   // the stage's 8 fields
        w[r][hh][0] = v.x >> sh;
        w[r][hh][1] = v.y >> sh;
        w[r][hh][2] = v.z >> sh;
        w[r][hh][3] = v.w >> sh;
      }
    const uint32_t xs = smem_u32(base);
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      uint32_t a[4][2][4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int u = 4 * hb + v;
        const int r = FB == 4 ? hb : 0;
        const int sh = FB * (FB == 4 ? v : u);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[v][mt][0] = code_pair<MP>(w[r][0][2 * mt], sh);
          a[v][mt][1] = code_pair<MP>(w[r][0][2 * mt + 1], sh);
          a[v][mt][2] = code_pair<MP>(w[r][1][2 * mt], sh);
          a[v][mt][3] = code_pair<MP>(w[r][1][2 * mt + 1], sh);
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(a[v][mt][e]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        // slice 4 hb + v: box hb of the stage, bytes 32 v of its rows
        const uint64_t du = desc_sw128(xs + hb * N * 128 + 32 * v);
        wgmma_rs<N>(acc[0], a[v][0], du);
        wgmma_rs<N>(acc[1], a[v][1], du);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) pin(acc[mt][e]);
}

// qfn-b: s (2/maxq y - xsum) with sc = s, k2 = 2/maxq; qfn-a:
// scale_i y - scale_i zero_i xsum with sc = scale_i, sz = zero_i
__device__ __forceinline__ float fixup(float ycodes, float xsum, int qfn_b,
                                       float k2, float sc, float sz) {
  return qfn_b ? sc * (k2 * ycodes - xsum) : sc * ycodes - sc * sz * xsum;
}

struct Plane {
  int fb, nw;
};

// Persistent: grid min(work items, SMs), NT threads; block k takes the
// work items k, k + gridDim.x, ... of tiles_x token tiles (fastest) x
// tiles_y column tiles x splits, and its producer runs on into the next
// item's stages while the consumers store the last one's. xmap0/1: each
// plane's x in stage order (dm_prep's xp, bf16 (B, 128 ns)), boxes of 64
// columns by N rows, 128-byte swizzle. wmap0/1: the planes (nw, m_p) as
// 32-bit words, boxes of 256 columns by 8 (16 for 4-bit fields) rows.
// splits == 1: out (B, m_p) gets the finished values (bf16 or f32);
// otherwise partial (splits, B, m_p) gets the weighted code products.
template <int N>
__global__ void __launch_bounds__(NT, 1)
dm_tile(const __grid_constant__ CUtensorMap xmap0,
        const __grid_constant__ CUtensorMap xmap1,
        const __grid_constant__ CUtensorMap wmap0,
        const __grid_constant__ CUtensorMap wmap1, int B, int d, int fb0,
        int fb1, int nplanes, float pw0, float pw1, int m_p, int tiles_x,
        int tiles_y, int splits, const float* __restrict__ xsum,
        float* __restrict__ partial, int qfn_b, float maxq,
        const float* __restrict__ scale, const float* __restrict__ zero,
        void* __restrict__ out, int out_bf16) {
  constexpr int STAGES = stages_for(N);
  extern __shared__ __align__(1024) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const int items = tiles_x * tiles_y * splits;
  const Plane pl[2] = {{fb0, d * fb0 / 32},
                       {nplanes > 1 ? fb1 : fb0,
                        d * (nplanes > 1 ? fb1 : fb0) / 32}};
  // work item -> (first token, first column, split)
  auto item = [&](int k, int& tok0, int& col0, int& split) {
    tok0 = k % tiles_x * N;
    k /= tiles_x;
    col0 = k % tiles_y * BN;
    split = k / tiles_y;
  };
  // stages of plane p: slices of (groups of 8 word rows) x fields, 8 each
  auto range = [&](int p, int split, int& s0, int& s1) {
    const int ns = ((pl[p].nw + 7) / 8 * (16 / pl[p].fb) + 7) / 8;
    s0 = (int)((long long)ns * split / splits);
    s1 = (int)((long long)ns * (split + 1) / splits);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int k = blockIdx.x; k < items; k += gridDim.x) {
      int tok0, col0, split;
      item(k, tok0, col0, split);
      for (int p = nplanes - 1; p >= 0; --p) {
        const int fph = 16 / pl[p].fb;
        const CUtensorMap* xmap = p ? &xmap1 : &xmap0;
        const CUtensorMap* wmap = p ? &wmap1 : &wmap0;
        const uint32_t bytes = x_bytes(N) + (pl[p].fb == 4 ? 16 : 8) * WROW * 4;
        int s0, s1;
        range(p, split, s0, s1);
        for (int s = s0; s < s1; ++s, ++it) {
          const int slot = it % STAGES;
          mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
          unsigned char* base = ring + slot * slot_bytes(N);
          mbar_expect_tx(&full[slot], bytes);
          // x: slices 8s .. 8s + 7, columns 128 s .. + 127 of xp
          for (int j = 0; j < 2; ++j)
            tma_load(base + j * N * 128, xmap, 128 * s + 64 * j, tok0,
                     &full[slot]);
          tma_load(base + x_bytes(N), wmap, col0, 8 * ((8 * s) / fph),
                   &full[slot]);
        }
      }
    }
    return;
  }

  // two consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = (threadIdx.x >> 7) - 1, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 128 * c + 32 * w + 4 * g;
  int it = 0;
  for (int k = blockIdx.x; k < items; k += gridDim.x) {
    int tok0, col0, split;
    item(k, tok0, col0, split);
    float acc[2][N / 2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mt][e] = 0.f;
    for (int p = nplanes - 1; p >= 0; --p) {
      int s0, s1;
      range(p, split, s0, s1);
      switch (pl[p].fb) {
        case 1:
          consume_plane<N, 1>(acc, s0, s1, it, ring, full, empty, col, t,
                              lane);
          break;
        case 2:
          consume_plane<N, 2>(acc, s0, s1, it, ring, full, empty, col, t,
                              lane);
          break;
        default:
          consume_plane<N, 4>(acc, s0, s1, it, ring, full, empty, col, t,
                              lane);
          break;
      }
      // sum_p pw_p S_p = pw0 (S0 + (pw1 / pw0) S1)
      const float f = p ? pw1 / pw0 : pw0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[mt][e] *= f;
    }

    // acc[mt][4i + 2h + e] is output column col0 + col + 2mt + h at token
    // 8i + 2t + e of the tile; m_p % 8 == 0: all 4 columns in or out.
    // Every load comes before the first store, so the stores stream.
    const int i0 = col0 + col;
    if (i0 >= m_p) continue;
    float xs[N / 8][2], sc[4], sz[4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = tok0 + 8 * i + 2 * t + e;
        xs[i][e] = splits == 1 && b < B ? xsum[b] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sc[q] = qfn_b ? scale[0] : scale[i0 + q];
      sz[q] = qfn_b ? 0.f : zero[i0 + q];
    }
    const float k2 = 2.0f / maxq;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = tok0 + 8 * i + 2 * t + e;
        if (b >= B) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = acc[q >> 1][4 * i + 2 * (q & 1) + e];
        if (splits > 1) {
          *reinterpret_cast<float4*>(partial + ((size_t)split * B + b) * m_p +
                                     i0) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = fixup(v[q], xs[i][e], qfn_b, k2, sc[q], sz[q]);
        if (out_bf16) {
          uint2 pk;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
          h[0] = __floats2bfloat162_rn(v[0], v[1]);
          h[1] = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) +
                                    (size_t)b * m_p + i0) = pk;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) +
                                     (size_t)b * m_p + i0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
  }
}

// One thread per (b, i): add the split partials in split order and apply
// the fixup.
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
  const float v = fixup(s, xsum[b], qfn_b, 2.0f / maxq,
                        qfn_b ? scale[0] : scale[i], qfn_b ? 0.f : zero[i]);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// 8 neighbouring elements of x as bf16 (p 16-byte aligned for bf16,
// 32-byte for f32)
__device__ __forceinline__ uint4 ld_eight(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return r;
}
__device__ __forceinline__ uint4 ld_eight(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Columns of x in a plane's stage order: 128 a stage (16 a slice).
__host__ __device__ inline int xp_cols(int d, int fb) {
  const int nw = d * fb / 32, fph = 16 / fb;
  return ((nw + 7) / 8 * fph + 7) / 8 * 128;
}

// One block per row b: xsum[b] = sum of bf16(x[b, :]); xp0 (and xp1 when
// not null) get bf16(x[b, :]) in plane 0's (plane 1's) stage order:
// column 16 L + c is x's column k*2nw + 16 rg + c of slice L = (rg = L /
// fph, k = L % fph), zero past the field's span (2nw % 8 == 0: a run of 8
// lies inside it or outside).
template <typename T>
__global__ void __launch_bounds__(256)
dm_prep(const T* __restrict__ x, int d, __nv_bfloat16* __restrict__ xp0,
        int fb0, __nv_bfloat16* __restrict__ xp1, int fb1,
        float* __restrict__ xsum) {
  __shared__ float red[8];
  const int b = blockIdx.x;
  const T* row = x + (size_t)b * d;
  float s = 0.f;
  for (int c = 8 * threadIdx.x; c < d; c += 8 * 256) {
    uint4 v = ld_eight(row + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      s += f.x + f.y;
    }
  }
  for (int p = 0; p < 2; ++p) {
    __nv_bfloat16* xp = p ? xp1 : xp0;
    if (xp == nullptr) continue;
    const int fb = p ? fb1 : fb0, fph = 16 / fb, two_nw = d * fb / 16;
    const int W = xp_cols(d, fb);
    for (int j = 8 * threadIdx.x; j < W; j += 8 * 256) {
      const int L = j >> 4, rg = L / fph, k = L - rg * fph;
      const int off = 16 * rg + (j & 15);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off < two_nw) v = ld_eight(row + k * two_nw + off);
      *reinterpret_cast<uint4*>(xp + (size_t)b * W + j) = v;
    }
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

// A row-major (rows, cols) matrix as a 2-D tensor map with boxes of
// (box_c, box_r), out-of-bounds elements zero.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
            const void* p, int rows, int cols, int box_c, int box_r,
            CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const __nv_bfloat16 *xp0, *xp1;
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

template <int N>
cudaError_t launch_tile(const Args& a, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dm_tile<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_for(N));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap xmap0, xmap1, wmap0, wmap1;
  const int fb1 = a.nplanes > 1 ? a.fb1 : a.fb0;
  if (!map_2d(&xmap0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.xp0, a.B,
              xp_cols(a.d, a.fb0), 64, N, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&xmap1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.xp1, a.B,
              xp_cols(a.d, fb1), 64, N, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&wmap0, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, a.plane0,
              a.d * a.fb0 / 32, a.m_p, WROW, a.fb0 == 4 ? 16 : 8,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !map_2d(&wmap1, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4,
              a.nplanes > 1 ? a.plane1 : a.plane0, a.d * fb1 / 32, a.m_p,
              WROW, fb1 == 4 ? 16 : 8, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int tiles_x = (a.B + N - 1) / N, tiles_y = (a.m_p + BN - 1) / BN;
  const int items = tiles_x * tiles_y * a.splits;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  dm_tile<N><<<items < sms ? items : sms, NT, smem_for(N), s>>>(
      xmap0, xmap1, wmap0, wmap1, a.B, a.d, a.fb0, a.fb1, a.nplanes, a.pw0,
      a.pw1, a.m_p, tiles_x, tiles_y, a.splits, a.xsum, a.partial, a.qfn_b,
      a.maxq, a.scale, a.zero, a.out, a.out_bf16);
  return cudaGetLastError();
}

bool fb_ok(int fb) { return fb == 1 || fb == 2 || fb == 4; }

}  // namespace

// x (B, d) and out (B, m_p) share one dtype: bf16 (is_bf16 = 1) or f32;
// x 32-byte aligned. planes: int32 (d*fb/32, m_p) each, d*fb % 128 == 0,
// m_p % 8 == 0, 16-byte aligned. n_tok: tokens a block, a multiple of 16
// in 16 .. 128; splits >= 1 parts of the fan-in. xp: bf16 scratch of B
// rows of 128 * (stages of plane 0) columns, and as much again for plane
// 1 when its fields are narrower or wider than plane 0's. work: f32
// scratch of B rounded up to 4 (+ splits*B*m_p when splits > 1), 16-byte
// aligned. qfn-b: scale -> one f32 (device); qfn-a: scale, zero -> (m_p,)
// f32. Returns the CUDA error code (0 = success).
extern "C" int quip_dequant_matmul_tile(
    const void* x, int is_bf16, int B, int d, const void* plane0, int fb0,
    const void* plane1, int fb1, int nplanes, float pw0, float pw1, int m_p,
    int n_tok, int splits, void* xp, void* work, int qfn_b, float maxq,
    const void* scale, const void* zero, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > 2 || !fb_ok(fb0) || (nplanes == 2 && !fb_ok(fb1)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || splits < 1 || m_p % 8 != 0 || (d * fb0) % 128 != 0 ||
      (nplanes == 2 && (d * fb1) % 128 != 0))
    return (int)cudaErrorInvalidValue;
  float* xsum = static_cast<float*>(work);
  __nv_bfloat16* xp0 = static_cast<__nv_bfloat16*>(xp);
  __nv_bfloat16* xp1 = nplanes == 2 && fb1 != fb0
                           ? xp0 + (size_t)B * xp_cols(d, fb0)
                           : nullptr;
  if (is_bf16) {
    dm_prep<__nv_bfloat16><<<B, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), d, xp0, fb0, xp1, fb1, xsum);
  } else {
    dm_prep<float><<<B, 256, 0, s>>>(static_cast<const float*>(x), d, xp0,
                                     fb0, xp1, fb1, xsum);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  Args a;
  a.xp0 = xp0;
  a.xp1 = xp1 != nullptr ? xp1 : xp0;
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
  switch (n_tok) {
    case 16: e = launch_tile<16>(a, s); break;
    case 32: e = launch_tile<32>(a, s); break;
    case 48: e = launch_tile<48>(a, s); break;
    case 64: e = launch_tile<64>(a, s); break;
    case 80: e = launch_tile<80>(a, s); break;
    case 96: e = launch_tile<96>(a, s); break;
    case 112: e = launch_tile<112>(a, s); break;
    case 128: e = launch_tile<128>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)B * m_p;
  dm_tile_finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      a.partial, splits, B, m_p, xsum, qfn_b, maxq, a.scale, a.zero, out,
      is_bf16);
  return (int)cudaGetLastError();
}
