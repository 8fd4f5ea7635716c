"""Port parity for K1′'s plain version (the slab-dot route).

The JAX slab-dot kernel itself lives in ``scripts/bench_kernel.py``, which
edits ``sys.path`` when imported and bit-casts with ``pltpu.bitcast``
(TPU only), so it is not run here: the oracle is
``quip_tpu.kernels.dequant_matmul.dequant_matmul_ref``, the function the
script itself checks its variants against, within the script's own limit
of 2e-2 of max |y| (the route pays f32 digits for its ``-128·Σx`` fix-up).
The slab values must equal ``128 + code`` bit for bit."""
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
