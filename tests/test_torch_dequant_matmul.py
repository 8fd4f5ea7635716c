"""Port parity for K1's plain version and qlinear_apply.

The port's plain dequant_matmul (the CPU path of the kernel wrapper) is
held against quip_tpu's dequant_matmul_ref and its Pallas kernel in
interpret mode (on the same bf16-cast x), and qlinear_apply against
quip_tpu's for the rht / rht_sf / rht_uf modes with padded planes and bias.
Tolerances: f32 vs f32 1e-5; vs the kernel 1e-3 (its accumulation order
around the folded 128-offset, as in tests/test_pack.py). ``tile_walk_ref``,
the plain-PyTorch walk of the planes that the tensor-core kernel makes
(slices, lane -> word map, 128 + c operands), is held against the plain
version to 1e-5 of max |y| at the rule's plan and at a forced split of the
fan-in (exact bf16 operands, f32 sums in another order), and against the
Pallas kernel ``_dequant_matmul_local`` in interpret mode to within 1e-5
of max |y| beyond the plain version's own distance from it (the Pallas
kernel takes its 128 offset off after an f32 sum of 128 + c products,
which costs it up to ~2.3e-5 of max |y| at 3 bits, d = 256). ``decode_walk_ref``, the walk of the decode kernel (codes as the A
operand, masked in place with x scaled to match, the 128 offsets taken off
once, splits added in order), is held to 1e-3 of max |y| against the plain
version and the Pallas kernel: its offsets cancel in f32."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.kernels.dequant_matmul import dequant_matmul as j_dm
from quip_tpu.kernels.dequant_matmul import dequant_matmul_ref as j_dm_ref
from quip_tpu.kernels.dequant_matmul import (
    _dequant_matmul_local as j_dm_local)
from quip_tpu.ops.qlinear import qlinear_apply as j_qlinear
from quip_tpu.pack import format as JF
from quip_tpu_torch import convert as TC
from quip_tpu_torch.convert import packed_from_numpy
from quip_tpu_torch.kernels import dequant_matmul as TDM
from quip_tpu_torch.ops.qlinear import qlinear_apply


@pytest.mark.parametrize("bits,qfn,code_bits", [
    (2, "b", None), (3, "b", None), (4, "b", None), (8, "b", None),
    (4, "b", 3), (2, "a", None), (4, "a", None)])
def test_plain_dequant_matmul_matches(bits, qfn, code_bits):
    rng = np.random.default_rng(bits * 10 + (qfn == "a"))
    B, m, d = 8, 256, 128
    cb = code_bits or bits
    codes = rng.integers(0, 2 ** cb, (m, d)).astype(np.int32)
    jplanes = JF.pack_codes(jnp.asarray(codes, jnp.int32), bits)
    tplanes = tuple(torch.from_numpy(np.array(p)) for p in jplanes)
    x = rng.standard_normal((B, d)).astype(np.float32)
    x_bf = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    if qfn == "b":
        scale_np, zero_np = np.float32(0.37), None
        jscale, jzero = jnp.asarray(scale_np, jnp.float32), None
        tscale, tzero = torch.tensor(scale_np), None
    else:
        scale_np = (rng.random(m) * 0.1 + 0.01).astype(np.float32)
        zero_np = rng.integers(0, 2 ** cb, m).astype(np.float32)
        jscale, jzero = jnp.asarray(scale_np), jnp.asarray(zero_np)
        tscale, tzero = torch.from_numpy(scale_np), torch.from_numpy(zero_np)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    got = TDM.dequant_matmul(torch.from_numpy(x_bf), tplanes, tscale, tzero,
                             **kw).numpy()
    want_ref = np.asarray(j_dm_ref(jnp.asarray(x_bf), jplanes, jscale, jzero,
                                   **kw))
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    want_kernel = np.asarray(j_dm(jnp.asarray(x), jplanes, jscale, jzero,
                                  tile_m=128, interpret=True, **kw))
    np.testing.assert_allclose(got, want_kernel, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mode", ["rht", "rht_sf", "rht_uf"])
@pytest.mark.parametrize("bits", [2, 3])
def test_qlinear_apply_matches(mode, bits):
    rng = np.random.default_rng(7)
    m, mp, d = 200, 256, 96         # planes padded 200 -> 256 out-features
    codes = np.zeros((mp, d), np.int32)
    codes[:m] = rng.integers(0, 2 ** bits, (m, d))
    planes = JF.pack_codes(jnp.asarray(codes), bits)
    scaleWH = jnp.asarray(rng.random(d) + 0.5, jnp.float32)
    key = jax.random.key_data(jax.random.key(3))
    q = JF.PackedLinear(
        planes, None, None, jnp.asarray(0.05, jnp.float32), scaleWH, key,
        jnp.asarray(rng.standard_normal(m), jnp.float32), bits=bits,
        qfn="b", proj_mode=mode, out_features=m, in_features=d,
        rot=JF.materialize_rotation(key, m, d, mode, scaleWH=scaleWH))
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = np.asarray(j_qlinear(q, jnp.asarray(x), use_kernel=False))
    tq = packed_from_numpy(jax.tree.map(np.asarray, q), device="cpu")
    got = qlinear_apply(tq, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, m)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


_FORMATS = [(2, "b", None), (3, "b", None), (4, "b", None), (8, "b", None),
            (4, "b", 3), (2, "a", None), (4, "a", None)]


def _case(rng, B, m, d, bits, qfn, code_bits):
    cb = code_bits or bits
    codes = rng.integers(0, 2 ** cb, (m, d)).astype(np.int32)
    jplanes = JF.pack_codes(jnp.asarray(codes, jnp.int32), bits)
    tplanes = tuple(torch.from_numpy(np.array(p)) for p in jplanes)
    x = rng.standard_normal((B, d)).astype(np.float32)
    x_bf = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    if qfn == "b":
        scale, zero = np.float32(0.37), None
    else:
        scale = (rng.random(m) * 0.1 + 0.01).astype(np.float32)
        zero = rng.integers(0, 2 ** cb, m).astype(np.float32)
    return x, x_bf, jplanes, tplanes, scale, zero


@pytest.mark.parametrize("d", [256, 1408])
@pytest.mark.parametrize("B", [9, 33])
@pytest.mark.parametrize("bits,qfn,code_bits", _FORMATS)
def test_tile_walk_matches_plain(bits, qfn, code_bits, B, d):
    """K1-tile's fragment map, stage order and split order (1408 = 11 *
    128: the 1-bit plane of 3-bit has 44 word rows, a ragged last group of
    8; m = 72 leaves a block of 256 columns mostly empty), at the rule's
    plan and with the fan-in in 3 splits of 16-token tiles."""
    rng = np.random.default_rng(bits * 1000 + B + d)
    m = 72
    _, x_bf, _, tplanes, scale, zero = _case(rng, B, m, d, bits, qfn,
                                             code_bits)
    assert TDM.tile_takes(d, m, bits)
    tscale = torch.from_numpy(np.asarray(scale))
    tzero = None if zero is None else torch.from_numpy(zero)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    want = TDM.dequant_matmul_ref(torch.from_numpy(x_bf), tplanes, tscale,
                                  tzero, **kw)
    for plan in (None, (16, 3)):
        got = TDM.tile_walk_ref(torch.from_numpy(x_bf), tplanes, tscale,
                                tzero, plan=plan, **kw)
        assert got.shape == want.shape == (B, m)
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-5, plan


@pytest.mark.parametrize("B", [33, 130])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_tile_walk_matches_pallas_kernel(bits, B):
    """The walk against quip_tpu's ``_dequant_matmul_local`` in interpret
    mode on the same bf16-cast x, f32 out: within 1e-5 of max |y| beyond
    the plain version's distance from the Pallas kernel (its f32 fold of
    the 128 offset)."""
    rng = np.random.default_rng(bits * 100 + B)
    m, d = 256, 256
    _, x_bf, jplanes, tplanes, scale, _ = _case(rng, B, m, d, bits, "b",
                                                None)
    want = np.asarray(j_dm_local(jnp.asarray(x_bf), jplanes,
                                 jnp.asarray(scale), None, bits=bits,
                                 tile_m=128, tile_b=B, interpret=True))
    kw = dict(bits=bits)
    xt, st = torch.from_numpy(x_bf), torch.tensor(float(scale))
    got = TDM.tile_walk_ref(xt, tplanes, st, None, **kw).numpy()
    plain = TDM.dequant_matmul_ref(xt, tplanes, st, None, **kw).numpy()
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= (1e-5 * top
                                        + np.abs(plain - want).max())
    assert np.abs(plain - want).max() <= 1e-4 * top


@pytest.mark.parametrize("B", [33, 130])
@pytest.mark.parametrize("bits,qfn,code_bits", [(2, "b", None),
                                                (3, "b", None),
                                                (4, "a", None)])
def test_plain_dequant_matmul_matches_batched(bits, qfn, code_bits, B):
    """The plain path at the batch sizes of the tensor-core kernel against
    quip_tpu's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(bits * 100 + B)
    m, d = 256, 128
    x, x_bf, jplanes, tplanes, scale, zero = _case(rng, B, m, d, bits, qfn,
                                                   code_bits)
    jzero = None if zero is None else jnp.asarray(zero)
    tzero = None if zero is None else torch.from_numpy(zero)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    got = TDM.dequant_matmul(torch.from_numpy(x_bf), tplanes,
                             torch.from_numpy(np.asarray(scale)), tzero,
                             **kw).numpy()
    want = np.asarray(j_dm(jnp.asarray(x), jplanes, jnp.asarray(scale), jzero,
                           tile_m=128, interpret=True, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_tile_dispatch_rule():
    """B <= 8 stays with the single-row kernel; K1-tile takes the shapes
    whose tensor maps have 16-byte strides; its plan (tokens a block,
    fan-in splits) is the least modelled cost on a card of 132 SMs."""
    assert TDM.TILE_MIN_B > 8
    assert TDM.tile_takes(4096, 12288, 2) and TDM.tile_takes(11008, 4096, 2)
    assert TDM.tile_takes(1408, 640, 3) and not TDM.tile_takes(96, 256, 3)
    assert not TDM.tile_takes(4096, 100, 2)
    assert TDM._tile_stages(4096, 2) == 32 and TDM._tile_stages(11008, 2) == 86
    assert TDM._tile_stages(1408, 1) == 12      # 6 row groups x 16 fields / 8
    assert TDM._tile_stages(4096, 4) == 32      # two groups of 8 a stage
    # (tokens a block, fan-in splits) on 132 SMs; the first five 2-bit
    # Llama-2-7B plans were the fastest of their neighbours in
    # tools/tune_tile.py's plan sweep on the H100
    assert TDM._tile_plan(600, 4096, 12288, 2, 132) == (128, 1)
    assert TDM._tile_plan(600, 4096, 4096, 2, 132) == (80, 1)   # one wave
    assert TDM._tile_plan(2048, 4096, 22528, 2, 132) == (128, 1)
    assert TDM._tile_plan(32, 4096, 4096, 2, 132) == (32, 8)
    assert TDM._tile_plan(16, 11008, 4096, 2, 132) == (16, 8)
    assert TDM._tile_plan(9, 4096, 32000, 2, 132) == (16, 1)
    for B, d, m, bits in [(9, 4096, 32000, 2), (600, 4096, 4096, 3),
                          (130, 1408, 72, 3)]:
        n, s = TDM._tile_plan(B, d, m, bits, 132)
        assert n in TDM.TILE_NS and n <= -(-B // 16) * 16
        depth = min(TDM._tile_stages(d, fb) for fb, _ in
                    TDM.PLANE_SPLITS[bits])
        assert 1 <= s <= max(1, min(16, depth // 4))


@pytest.mark.parametrize("d", [256, 1408])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("bits,qfn,code_bits", _FORMATS)
def test_decode_walk_matches_plain(bits, qfn, code_bits, B, d):
    """K1-decode's tile map, scaled staging, batches and split order (1408:
    the 1-bit plane of 3-bit has 44 word rows, a ragged last group of 8;
    m = 76 leaves a ragged m-tile of 64 columns; the rule's splits, a
    number that does not divide the groups, and two). 1e-3 of max |y| on
    f32-held bf16 inputs."""
    rng = np.random.default_rng(bits * 1000 + B + d)
    m = 76
    _, x_bf, _, tplanes, scale, zero = _case(rng, B, m, d, bits, qfn,
                                             code_bits)
    tscale = torch.from_numpy(np.asarray(scale))
    tzero = None if zero is None else torch.from_numpy(zero)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    want = TDM.dequant_matmul_ref(torch.from_numpy(x_bf), tplanes, tscale,
                                  tzero, **kw)
    for splits in (None, 3, 2):
        got = TDM.decode_walk_ref(torch.from_numpy(x_bf), tplanes, tscale,
                                  tzero, splits=splits, **kw)
        assert got.shape == want.shape == (B, m)
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("bits,qfn,code_bits", _FORMATS)
def test_decode_walk_matches_pallas_kernel(bits, qfn, code_bits, B):
    """The decode walk against quip_tpu's Pallas kernel in interpret mode on
    the same bf16-cast x (1e-3 of max |y|, as the plain version is held)."""
    rng = np.random.default_rng(bits * 100 + B + 7)
    m, d = 256, 256
    x, x_bf, jplanes, tplanes, scale, zero = _case(rng, B, m, d, bits, qfn,
                                                   code_bits)
    jzero = None if zero is None else jnp.asarray(zero)
    tzero = None if zero is None else torch.from_numpy(zero)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    got = TDM.decode_walk_ref(torch.from_numpy(x_bf), tplanes,
                              torch.from_numpy(np.asarray(scale)), tzero,
                              **kw).numpy()
    want = np.asarray(j_dm(jnp.asarray(x), jplanes, jnp.asarray(scale), jzero,
                           tile_m=128, interpret=True, **kw))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_decode_dispatch_rule():
    """K1-decode up to 8 rows, K1-tile above where it takes the shape, else
    K1-decode again; the decode plan (splits <= 6 of the 8 a cluster holds,
    one block of 256 columns an SM) on a card of 132 SMs; the ring only
    where a plane has a tensor map."""
    assert TDM.DECODE_MAX_B == 8 and TDM.DECODE_MAX_SPLITS == 8
    for B in range(1, 9):
        assert TDM.route(B, 4096, 12288, 2) == "decode"
    assert TDM.route(9, 4096, 12288, 2) == "tile"
    assert TDM.route(600, 11008, 4096, 2) == "tile"
    assert TDM.route(40, 96, 100, 2) == "decode"      # K1-tile refuses it
    assert TDM.route(3, 96, 100, 2) == "decode"
    assert TDM._decode_plan(1, 4096, 12288, 2, 132) == 2
    assert TDM._decode_plan(1, 4096, 4096, 2, 132) == 4   # 4 divides 32
    assert TDM._decode_plan(1, 4096, 22528, 2, 132) == 1
    assert TDM._decode_plan(1, 11008, 4096, 2, 132) == 6  # 86 groups
    assert TDM._decode_plan(1, 4096, 32000, 2, 132) == 1
    assert TDM._decode_plan(8, 4096, 32000, 2, 132) == 1
    assert TDM._decode_plan(4, 16384, 4096, 2, 132) == 4
    assert TDM._decode_plan(1, 96, 100, 3, 132) == 1
    # 8 rows of a 28672-wide x at 4 bits: splits until x's staged copy
    # fits the block's shared memory
    splits = TDM._decode_plan(8, 56320, 8192, 4, 132)
    assert (TDM._decode_smem(8, 56320, 4, splits) <= TDM.DECODE_SMEM_MAX
            < TDM._decode_smem(8, 56320, 4, splits - 1))
    # x's staged rows: B rounded up to a power of two
    assert [TDM._pad_rows(B) for B in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8,
                                                       8]
    assert TDM.decode_groups(1408, 1) == 6 and TDM.decode_groups(96, 1) == 1
    ok = torch.zeros((64, 256), dtype=torch.int32)
    assert not TDM.decode_ragged((ok,))
    assert TDM.decode_ragged((torch.zeros((64, 330), dtype=torch.int32),))
    shifted = torch.zeros(64 * 256 + 1, dtype=torch.int32)[1:].view(64, 256)
    assert TDM.decode_ragged((ok, shifted))          # not 16-byte aligned


@pytest.mark.parametrize("name", ["packed_from_numpy", "kvcache_from_numpy",
                                  "paged_from_numpy", "prefix_from_numpy"])
def test_converters_default_to_the_card(name):
    """Every converter is an entry point: its device defaults to "cuda" and,
    with no card, the default raises instead of running on the CPU."""
    fn = getattr(TC, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(object())
