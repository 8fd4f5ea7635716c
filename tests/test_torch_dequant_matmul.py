"""Port parity for K1's plain version and qlinear_apply.

The port's plain dequant_matmul (the CPU path of the kernel wrapper) is
held against quip_tpu's dequant_matmul_ref and its Pallas kernel in
interpret mode (on the same bf16-cast x), and qlinear_apply against
quip_tpu's for the rht / rht_sf / rht_uf modes with padded planes and bias.
Tolerances: f32 vs f32 1e-5; vs the kernel 1e-3 (its accumulation order
around the folded 128-offset, as in tests/test_pack.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.kernels.dequant_matmul import dequant_matmul as j_dm
from quip_tpu.kernels.dequant_matmul import dequant_matmul_ref as j_dm_ref
from quip_tpu.ops.qlinear import qlinear_apply as j_qlinear
from quip_tpu.pack import format as JF
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
    tq = packed_from_numpy(jax.tree.map(np.asarray, q))
    got = qlinear_apply(tq, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, m)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
