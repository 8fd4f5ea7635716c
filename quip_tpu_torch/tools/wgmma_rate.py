"""How fast the tensor cores take K1-decode's products (run on the H100):

    python -m quip_tpu_torch.tools.wgmma_rate

Times back-to-back ``wgmma.mma_async.m64nNk16`` (bf16 in, f32 out, A from
registers, B K-major without swizzle in shared memory, as in
``csrc/dequant_matmul_decode.cu``) with nothing else in the loop: N = 8,
16 and 32; one, two and eight accumulator chains; batches of 8 to 32
products between ``commit`` and ``wait_group``; one batch left in flight
(``wait_group 1``) or none (``wait_group 0``); the A registers rewritten
before every batch or not; one, two and four warpgroups an SM (blocks of
one warpgroup, one, two and four times the SMs). Prints the card's name
and power limit and, for each case, the ms and the SM clocks a product
takes an SM at the card's highest SM clock (``nvidia-smi``'s
``clocks.max.sm``; a card held below it takes fewer).
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from quip_tpu_torch.tools.variants import build, card

SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper.cuh"

namespace {
template <int N>
__device__ __forceinline__ void wg(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t desc);
template <>
__device__ __forceinline__ void wg<8>(float (&d)[4], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wg<16>(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wg<32>(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 2 iters batches of BATCH products on chains i % CH; REWRITE: one xor on
// every A register before each batch
template <int N, int CH, int BATCH, int W, bool REWRITE>
__global__ void __launch_bounds__(128) bench(float* out, int iters) {
  __shared__ __align__(128) uint32_t bsm[N * 16];
  for (int i = threadIdx.x; i < N * 16; i += 128) bsm[i] = 0x3f803f80u;
  fence_proxy_async();
  __syncthreads();
  float acc[CH][N / 2];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[c][e] = 0.f;
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[s][e] = 0x3f803f80u ^ (threadIdx.x + e + s);
  const uint64_t desc = desc_plain(smem_u32(bsm), 128);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (REWRITE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[s][e] ^= (uint32_t)it & 1u;
          pin(a[s][e]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < BATCH; ++i) wg<N>(acc[i % CH], a[s], desc);
      wgmma_commit();
      wgmma_wait<W>();
    }
  }
  wgmma_wait<0>();
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) t += acc[c][e];
  out[blockIdx.x * 128 + threadIdx.x] = t;
}
}  // namespace

#define CASE(N, CH, BATCH, W, RW)                                          \
  if (n == N && ch == CH && batch == BATCH && w == W && rw == RW) {          \
    bench<N, CH, BATCH, W, RW><<<blocks, 128>>>(out, iters);                 \
    return (int)cudaGetLastError();                                          \
  }

extern "C" int wgmma_rate(int n, int ch, int batch, int w, int rw,
                          int blocks, int iters, float* out) {
  CASE(8, 1, 8, 1, 0) CASE(8, 2, 8, 1, 0) CASE(8, 8, 8, 1, 0)
  CASE(8, 1, 8, 0, 0) CASE(8, 1, 16, 1, 0) CASE(8, 1, 32, 1, 0)
  CASE(8, 1, 8, 1, 1) CASE(16, 1, 8, 1, 0) CASE(32, 1, 8, 1, 0)
  return -1;
}
'''

CASES = [(8, 1, 8, 1, 0), (8, 2, 8, 1, 0), (8, 8, 8, 1, 0), (8, 1, 8, 0, 0),
         (8, 1, 16, 1, 0), (8, 1, 32, 1, 0), (8, 1, 8, 1, 1),
         (16, 1, 8, 1, 0), (32, 1, 8, 1, 0)]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_rate: needs a CUDA card")
    print(card())
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0]) * 1e6
    f = build({"wgmma_rate": SRC}, "wgmma_rate",
              [ctypes.c_int] * 7 + [ctypes.c_void_p])["wgmma_rate"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(4 * sms * 128, device="cuda")
    for per_sm in (1, 2, 4):
        for n, ch, batch, w, rw in CASES:
            blocks, iters = per_sm * sms, 2000
            assert f(n, ch, batch, w, rw, blocks, 10, out.data_ptr()) == 0
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            assert f(n, ch, batch, w, rw, blocks, iters, out.data_ptr()) == 0
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            per_sm_products = blocks * iters * 2 * batch / sms
            print(f"{per_sm} warpgroup(s) an SM, m64n{n}k16, {ch} chain(s), "
                  f"batches of {batch}, wait_group {w}"
                  + (", A rewritten" if rw else "")
                  + f": {ms:.3f} ms, {ms * 1e-3 * clock / per_sm_products:.1f}"
                  f" SM clocks a product at {clock / 1e6:.0f} MHz",
                  flush=True)


if __name__ == "__main__":
    main()
