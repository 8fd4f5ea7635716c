"""Port parity for K1′ (the slab-dot route): its plain version and the
walk of its CUDA kernel against the JAX slab-dot kernel itself.

The JAX kernel lives in ``scripts/bench_kernel.py`` (``slabdot_matmul`` ->
``_slabdot_kernel``). The script is loaded from its file as it is, and its
module's ``pl`` is replaced by a namespace whose ``pallas_call`` passes
``interpret=True``, so the Pallas kernel runs here on the CPU; no file of
the JAX package changes. ``slabdot_matmul_ref`` and ``slabdot_walk_ref``
repeat its arithmetic in another summation order: within 1e-4 of max |y|
with f32 x, 1e-2 with bf16 x and output (one bf16 rounding of the output).
Against ``dequant_matmul_ref`` the route keeps the script's own limit of
2e-2 (it pays f32 digits for its ``-128·Σx`` fix-up). The slab values must
equal ``128 + code`` bit for bit."""
import functools
import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.kernels.dequant_matmul import dequant_matmul_ref as j_dm_ref
from quip_tpu.pack import format as JF
from quip_tpu_torch.kernels import dequant_matmul as TDM
from quip_tpu_torch.kernels import slabdot as SD
from quip_tpu_torch.pack.format import PLANE_SPLITS, _unpack_plane


def _case(bits, m=256, d=128, B=3):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, (m, d)).astype(np.int32)
    jplanes = JF.pack_codes(jnp.asarray(codes, jnp.int32), bits)
    tplanes = tuple(torch.from_numpy(np.array(p)) for p in jplanes)
    x = rng.standard_normal((B, d)).astype(np.float32)
    x_bf = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return codes, jplanes, tplanes, x_bf


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_slabdot_matches_dequant_matmul_ref(bits):
    _, jplanes, tplanes, x = _case(bits)
    got = SD.slabdot_matmul(torch.from_numpy(x), tplanes, 0.37, bits=bits,
                            tile_m=128).numpy()
    lim = 2e-2
    want_j = np.asarray(j_dm_ref(jnp.asarray(x), jplanes,
                                 jnp.asarray(0.37, jnp.float32), None,
                                 bits=bits, qfn="b"))
    assert np.abs(got - want_j).max() <= lim * np.abs(want_j).max()
    want_t = TDM.dequant_matmul_ref(torch.from_numpy(x), tplanes,
                                    torch.tensor(0.37), None,
                                    bits=bits).numpy()
    assert np.abs(got - want_t).max() <= lim * np.abs(want_t).max()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_slab_values_are_128_plus_code(bits):
    codes, _, tplanes, _ = _case(bits)
    d = codes.shape[1]
    shift = 0
    for plane, (fb, _) in zip(tplanes, PLANE_SPLITS[bits]):
        slabs = torch.cat([SD.slab_values(plane, fb, k)
                           for k in range(16 // fb)])        # (d, m)
        want = 128 + _unpack_plane(plane, fb, d).t()
        assert slabs.dtype == torch.float32
        assert torch.equal(slabs, want.to(torch.float32))
        # and the plane's codes are the packed codes' field
        field = (codes >> shift) & ((1 << fb) - 1)
        assert np.array_equal(want.t().numpy() - 128, field)
        # every value is a bf16: the low 16 bits of its f32 word are clear
        assert not (slabs.view(torch.int32) & 0xFFFF).any()
        shift += fb


def test_bf16_in_bf16_out_and_x_rounding():
    """x is rounded to bf16 inside, whatever its dtype."""
    _, _, tplanes, x = _case(2)
    noisy = torch.from_numpy(x) * (1 + 2e-4)      # rounds back to x's bf16
    a = SD.slabdot_matmul(torch.from_numpy(x), tplanes, 0.1, bits=2,
                          tile_m=256)
    b = SD.slabdot_matmul(noisy.bfloat16(), tplanes, 0.1, bits=2, tile_m=128)
    assert b.dtype == torch.bfloat16
    np.testing.assert_allclose(b.float().numpy(), a.numpy(), rtol=1e-2,
                               atol=1e-2 * float(a.abs().max()))


@pytest.mark.parametrize("tile_m", [0, 64, 192, 384])
def test_rejects_illegal_tile_m(tile_m):
    _, _, tplanes, x = _case(2)
    with pytest.raises(ValueError, match="tile_m"):
        SD.slabdot_matmul(torch.from_numpy(x), tplanes, 0.1, bits=2,
                          tile_m=tile_m)


def test_bench_kernel_tiles_and_variants():
    """The microbenchmark's shape list, legal tile_m rule and variant table
    (quip_tpu's scripts/bench_kernel.py:134-154), on CPU tensors."""
    from quip_tpu_torch.tools import bench_kernel as BK
    assert BK.SHAPES == [(4096, 4096), (12288, 4096), (22016, 4096),
                         (4096, 11008), (32000, 4096)]
    assert BK.legal_tiles(22016) == [512, 5504]
    assert BK.legal_tiles(32000) == [640, 1280, 3200]
    assert BK.legal_tiles(4096) == [512, 1024, 2048]
    gen = torch.Generator().manual_seed(0)
    x, copies, scale = BK.make_case(1024, 128, 2, 1, gen, l2_bytes=1e5)
    assert len(copies) == 4 and copies[0][0].shape == (8, 1024)
    vs = BK.variants(x, scale, 2, 1024)
    assert list(vs) == ["concat/dflt", "k1-tile", "slabdot/512",
                        "slabdot/1024"]
    errs = BK.check_agreement(vs, copies[0])
    assert errs["concat/dflt"] == 0 and max(errs.values()) < BK.AGREE


_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "bench_kernel.py")


@pytest.fixture(scope="module")
def pallas_slabdot():
    """``scripts/bench_kernel.py``'s ``slabdot_matmul`` with its Pallas
    kernel in interpret mode."""
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location("_bench_kernel_script",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)         # the script puts its own tree on sys.path
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod.slabdot_matmul


def _pallas_case(bits, B, m, d, seed):
    """numpy-seeded codes packed by quip_tpu (the port's planes are the same
    words) and f32 x."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** bits, (m, d)).astype(np.int32)
    jplanes = JF.pack_codes(jnp.asarray(codes, jnp.int32), bits)
    tplanes = tuple(torch.from_numpy(np.array(p)) for p in jplanes)
    x = rng.standard_normal((B, d)).astype(np.float32)
    return jplanes, tplanes, x


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("tile_m", [128, 640])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_plain_matches_pallas_kernel(pallas_slabdot, bits, B, tile_m):
    """slabdot_matmul_ref against the script's Pallas kernel (interpret
    mode), m=640, d=1024: f32 x within 1e-4, bf16 x and out within 1e-2."""
    jplanes, tplanes, x = _pallas_case(bits, B, 640, 1024, 10 * bits + B)
    want = pallas_slabdot(jnp.asarray(x), jplanes, 0.37, bits=bits,
                          tile_m=tile_m)
    got = SD.slabdot_matmul_ref(torch.from_numpy(x), tplanes, 0.37,
                                bits=bits)
    assert _rel(got.numpy(), want) <= 1e-4
    want16 = pallas_slabdot(jnp.asarray(x, jnp.bfloat16), jplanes, 0.37,
                            bits=bits, tile_m=tile_m)
    got16 = SD.slabdot_matmul_ref(torch.from_numpy(x).bfloat16(), tplanes,
                                  0.37, bits=bits)
    assert want16.dtype == jnp.bfloat16 and got16.dtype == torch.bfloat16
    assert _rel(got16.float().numpy(), want16.astype(jnp.float32)) <= 1e-2


@pytest.mark.parametrize("bits,B,m,d,tile_m", [
    (b, B, 640, 1024, t) for b in (2, 3, 4) for B in (1, 3, 8)
    for t in (128, 640)] + [
    # 11 and 6 groups of word rows over 4 splits: uneven splits, slots of
    # one group, a ragged last group of the 1-bit plane; two tiles of rows
    (3, 13, 384, 1408, 384),
    # 2 nw not a multiple of 8 (x staged pair by pair), one split
    (3, 3, 256, 96, 128),
    # 8 rows x 1280 columns of partials pass 32 KB: two chunks
    (2, 13, 1280, 128, 1280)])
def test_walk_matches_plain_and_pallas(pallas_slabdot, bits, B, m, d, tile_m):
    """The kernel's grid, ring, fragments and split-order reduction walked
    in plain PyTorch, against slabdot_matmul_ref and the Pallas kernel
    (f32 x, 1e-4 of max |y|)."""
    jplanes, tplanes, x = _pallas_case(bits, B, m, d, 10 * bits + B)
    xt = torch.from_numpy(x)
    walk = SD.slabdot_walk_ref(xt, tplanes, 0.37, bits=bits, tile_m=tile_m)
    assert _rel(walk.numpy(), SD.slabdot_matmul_ref(
        xt, tplanes, 0.37, bits=bits).numpy()) <= 1e-4
    want = pallas_slabdot(jnp.asarray(x), jplanes, 0.37, bits=bits,
                          tile_m=tile_m)
    assert _rel(walk.numpy(), want) <= 1e-4


def test_plan_rule():
    """splits: a power of two, within two blocks an SM (the kernel's
    register budget), at most 8 and the shortest plane's groups, doubled
    where x's staged rows would not fit; chunks of partials within 32 KB;
    a block's shared memory: the ring, the partials, x once a distinct
    field width (8-bit's two 4-bit planes share it) and 128 + 128 bytes."""
    assert SD._plan(4096, 512, 1, 4096, [2], 132) == (8, 512)
    assert SD._plan(22016, 512, 1, 4096, [2], 132) == (4, 512)
    assert SD._plan(32000, 640, 1, 4096, [2], 132) == (4, 640)
    assert SD._plan(32000, 128, 1, 4096, [2], 132) == (2, 128)
    assert SD._plan(32000, 32000, 8, 4096, [2], 132) == (8, 1024)
    assert SD._plan(640, 640, 13, 1024, [2, 1], 132) == (4, 640)
    assert SD._plan(256, 128, 3, 96, [2, 1], 132) == (1, 128)
    # 8 rows of an 11008-wide x at 3 bits: one split does not fit
    splits, chunk = SD._plan(4096, 4096, 8, 11008, [2, 1], 1)
    assert splits > 1 and chunk == 1024
    assert SD._smem_bytes(8, 11008, [2, 1], splits, chunk) <= SD.SMEM_MAX
    assert SD._smem_bytes(8, 11008, [2, 1], splits // 2, chunk) > SD.SMEM_MAX
    ring = 4 * SD.STAGES * 8 * SD.GPS * SD.SROW
    assert SD._smem_bytes(1, 4096, [2], 8, 512) == (
        128 + ring + 4 * 512 + 128 + 8 * 2 * 4 * 16)
    assert SD._smem_bytes(5, 4096, [4, 4], 8, 512) == (
        128 + ring + 4 * 5 * 512 + 128 + 4 * 2 * 8 * (16 * 8 + 16))


@pytest.mark.parametrize("tool,name", [
    ("tune_slabdot", "slabdot_matmul.cu"),
    ("tune_decode", "dequant_matmul_decode.cu")])
def test_tuning_copies_apply(tool, name):
    """The tuning tools' copies of K1′ and K1-decode are text edits of each
    source with the device code the two share (``csrc/decode_common.cuh``,
    ``csrc/hopper.cuh``) written out in place: every edit finds its text
    (``variants.rep`` asserts it) and changes the source; K1-decode's
    stamped copies too."""
    import importlib
    from quip_tpu_torch.tools import variants as V
    mod = importlib.import_module(f"quip_tpu_torch.tools.{tool}")
    src = V.source(name, headers=True)
    assert '#include "' not in src and "#pragma once" not in src
    assert src.count("consume_plane(") >= 1 and "sd_kernel" in V.source(
        "slabdot_matmul.cu", headers=True)
    vs = mod.variants(src)
    assert vs["as it is"] == src and len(set(vs.values())) == len(vs)
    if tool == "tune_decode":
        assert all("decode_stamps" in mod._stamped(v) for v in vs.values())
