"""Port parity for K3's plain version and the fused-RHT qlinear path.

``rht_apply_fused`` on CPU tensors takes ``rht_apply_fused_ref`` (the CUDA
kernel's plain version). It is held against quip_tpu's Pallas kernel in
interpret mode and against ``core/incoherence.apply_rht`` on the same
numpy inputs, for the factor shapes of tests/test_rht_kernel.py: pow2 x
pow2 (64 = 8 x 8), pow2 x dense orthogonal (96 = 8 x 12, 352 = 32 x 11) and
right-factor-free (n = a). Tolerances as there: 2e-5 in f32 (summation
order), 2e-2 in bf16 (one rounding per product). ``rht_walk_ref``, the
plain-PyTorch walk of the bf16 tensor-core kernel's tiles (column blocks of
16 or 64, operands padded to 16, the orientation of each staged factor), is
held to the same limits against the plain version and the Pallas kernel."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quip_tpu.kernels.rht as JK3
from quip_tpu.core import incoherence as jinc
from quip_tpu.models import get_config as jget_config
from quip_tpu.ops.qlinear import qlinear_apply as j_qlinear
from quip_tpu_torch.convert import packed_from_numpy
from quip_tpu_torch.kernels import rht as TK3
from quip_tpu_torch.ops import qlinear as TQ
from tests.test_torch_model import _jax_packed_llama

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rht(n, seed=3, right=True):
    """quip_tpu's transform for n (numpy f32 parts), or an 8 x 8 Hadamard
    with no right factor."""
    if right:
        t = jinc.gen_rht(jax.random.key(seed), n, jnp.float32)
        return (np.asarray(t.signs, np.float32),
                np.asarray(t.left, np.float32),
                np.asarray(t.right, np.float32))
    t = jinc.gen_rht(jax.random.key(seed), n * n, jnp.float32)
    return (np.asarray(t.signs, np.float32)[:n],
            np.asarray(t.left, np.float32), None)


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.array(a)).to(
        dtype or torch.float32)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("n,right", [(64, True), (96, True), (352, True),
                                     (8, False)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_apply_rht(n, right, transpose, dtype):
    signs, left, rt = _rht(n, right=right)
    x = np.random.default_rng(4).standard_normal((8, n)).astype(np.float32)
    xj = _j(x).astype(_JDT[dtype])
    got = TK3.rht_apply_fused(_t(x).to(_TDT[dtype]), _t(signs), _t(left),
                              _t(rt), transpose=transpose)
    assert got.dtype == _TDT[dtype]
    got = got.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    kern = JK3.rht_apply_fused(xj, _j(signs), _j(left), _j(rt),
                               transpose=transpose, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), rtol=tol,
                               atol=tol)
    t = jinc.RHT(_j(signs), _j(left), _j(rt), n)
    want = jinc.apply_rht(t, xj, axis=-1, transpose=transpose)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n,right", [(64, True), (96, True), (352, True),
                                     (1376, True), (500, True), (8, False),
                                     (64, False)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_walk_matches_plain_and_pallas(n, right, transpose, B):
    """The bf16 kernel's walk (1376 = 32 x 43 and 500 = 4 x 125: ragged
    column blocks and row tiles; ``sms=4`` makes 32 rows take 64-column
    blocks and several rows a block) within 2e-2 of max |y| of the plain
    version and of quip_tpu's Pallas kernel in interpret mode; the f32 plain
    version, which the f32 kernel repeats, within 2e-5 of the Pallas kernel
    in f32."""
    signs, left, rt = _rht(n, right=right)
    rng = np.random.default_rng(n + B)
    x = rng.standard_normal((B, n)).astype(np.float32)
    vec = (signs / (rng.random(n) + 0.5)).astype(np.float32)
    for dtype, tol in (("bfloat16", 2e-2), ("float32", 2e-5)):
        xt = _t(x).to(_TDT[dtype])
        plain = TK3.rht_apply_fused_ref(xt, _t(vec), _t(left), _t(rt),
                                        transpose=transpose).float().numpy()
        kern = np.asarray(JK3.rht_apply_fused(
            _j(x).astype(_JDT[dtype]), _j(vec), _j(left), _j(rt),
            transpose=transpose, interpret=True), np.float32)
        top = np.abs(kern).max()
        assert np.abs(plain - kern).max() <= tol * top
        if dtype == "bfloat16":
            for sms in (132, 4):
                walk = TK3.rht_walk_ref(xt, _t(vec), _t(left), _t(rt),
                                        transpose=transpose,
                                        sms=sms).float().numpy()
                assert walk.shape == (B, n)
                assert np.abs(walk - plain).max() <= tol * top
                assert np.abs(walk - kern).max() <= tol * top


def test_block_plan_rule():
    """16 columns a block while few rows leave the card empty, 64 from half
    a wave of 64-column blocks on, several rows a block only beyond two
    blocks an SM (132 SMs)."""
    assert TK3.block_plan(1, 250, 132) == (16, 1)
    assert TK3.block_plan(8, 250, 132) == (16, 1)
    assert TK3.block_plan(32, 250, 132) == (64, 1)
    assert TK3.block_plan(32, 172, 132) == (64, 1)
    assert TK3.block_plan(32, 64, 132) == (16, 1)
    assert TK3.block_plan(32, 1, 132) == (16, 1)
    assert TK3.block_plan(600, 250, 132) == (64, 10)


def test_roundtrip_inverse():
    signs, left, rt = _rht(96, seed=5)
    x = _t(np.random.default_rng(6).standard_normal((8, 96)))
    y = TK3.rht_apply_fused(x, _t(signs), _t(left), _t(rt))
    back = TK3.rht_apply_fused(y, _t(signs), _t(left), _t(rt),
                               transpose=True)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)


def test_scalewh_fold():
    """vec = signs / scaleWH reproduces quip_tpu's divide-then-rotate."""
    signs, left, rt = _rht(64, seed=7)
    rng = np.random.default_rng(8)
    swh = (np.abs(rng.standard_normal(64)) + 0.5).astype(np.float32)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    t = jinc.RHT(_j(signs), _j(left), _j(rt), 64)
    want = jinc.apply_rht(t, _j(x) / _j(swh)[None, :], axis=-1)
    got = TK3.rht_apply_fused(_t(x), _t(signs / swh), _t(left), _t(rt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rejects_bad_split():
    with pytest.raises(ValueError, match="split"):
        TK3.rht_apply_fused(torch.zeros(2, 12), torch.ones(12),
                            torch.eye(4), torch.eye(4))


@pytest.fixture
def packed_layers():
    """A packed llama-tiny layer's wqkv (scaleWH-free) in both packages."""
    cfg = dataclasses.replace(jget_config("llama-tiny"), n_layers=1)
    params = _jax_packed_llama(cfg, seed=0)
    jq = jax.tree.map(lambda p: p[0], params["blocks"])["attn"]["wqkv"]
    return jq, packed_from_numpy(jax.tree.map(np.asarray, jq),
                                 device="cpu")


@pytest.mark.parametrize("rows", [(8,), (2, 3), (5, 8)])
def test_qlinear_fused_matches(packed_layers, monkeypatch, rows):
    """QUIP_FUSED_RHT=1: the port's fused branch (K3's plain version around
    K1's) against the port's un-fused path and against quip_tpu's
    qlinear_apply running ITS fused branch (both Pallas kernels in interpret
    mode; its rht_apply_fused call is given interpret=True here, which
    ops/qlinear.py only gets on a TPU). 40 rows exceed the 32-row gate and
    must take the un-fused path. f32: 1e-4 (summation order; the kernel's
    folded 128 offset as in tests/test_torch_dequant_matmul.py: 1e-3)."""
    jq, tq = packed_layers
    x = np.random.default_rng(10).standard_normal(
        rows + (jq.in_features,)).astype(np.float32)
    plain = TQ.qlinear_apply(tq, torch.from_numpy(x)).numpy()
    calls = []
    real = TQ.rht_apply_fused
    monkeypatch.setattr(TQ, "rht_apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    fused = TQ.qlinear_apply(tq, torch.from_numpy(x)).numpy()
    n_rows = int(np.prod(rows))
    assert len(calls) == (2 if n_rows <= 32 else 0)
    np.testing.assert_allclose(fused, plain, rtol=1e-4, atol=1e-4)
    want_plain = np.asarray(j_qlinear(jq, jnp.asarray(x), use_kernel=False))
    np.testing.assert_allclose(fused, want_plain, rtol=1e-4, atol=1e-4)
    if n_rows <= 32:
        monkeypatch.setenv("QUIP_KERNEL_INTERPRET", "1")
        monkeypatch.setattr(JK3, "rht_apply_fused", functools.partial(
            JK3.rht_apply_fused, interpret=True))
        want = np.asarray(j_qlinear(jq, jnp.asarray(x)))
        np.testing.assert_allclose(fused, want, rtol=1e-3, atol=1e-3)


def test_fused_gate_reads_env_at_call_time(monkeypatch):
    monkeypatch.delenv("QUIP_FUSED_RHT", raising=False)
    assert not TQ._fused_rht_enabled()
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    assert TQ._fused_rht_enabled()
    monkeypatch.setenv("QUIP_FUSED_RHT", "0")
    assert not TQ._fused_rht_enabled()
