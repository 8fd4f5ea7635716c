"""Port parity for K3's plain version and the fused-RHT qlinear path.

``rht_apply_fused`` on CPU tensors takes ``rht_apply_fused_ref`` (the CUDA
kernel's plain version). It is held against quip_tpu's Pallas kernel in
interpret mode and against ``core/incoherence.apply_rht`` on the same
numpy inputs, for the factor shapes of tests/test_rht_kernel.py: pow2 x
pow2 (64 = 8 x 8), pow2 x dense orthogonal (96 = 8 x 12, 352 = 32 x 11) and
right-factor-free (n = a). Tolerances as there: 2e-5 in f32 (summation
order), 2e-2 in bf16 (one rounding per product). ``rht_walk_ref``, the
plain-PyTorch walk of the bf16 kernel's tiles (blocks of 32 output
columns, operands as ``prepare`` lays them out and read back through the
kernel's descriptor addressing), is held to the same limits against the
plain version and the Pallas kernel, at these shapes and at every split
of the served models' widths."""
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
    column blocks, odd b, row tiles of 4 and 32 rows padded to 64) within
    2e-2 of max |y| of the plain version and of quip_tpu's Pallas kernel in
    interpret mode; the f32 plain version, which the f32 kernel repeats,
    within 2e-5 of the Pallas kernel in f32."""
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
            walk = TK3.rht_walk_ref(xt, _t(vec), _t(left), _t(rt),
                                    transpose=transpose).float().numpy()
            assert walk.shape == (B, n)
            assert np.abs(walk - plain).max() <= tol * top
            assert np.abs(walk - kern).max() <= tol * top


# every (a, b) split of the served models' widths: Llama-2-7B's 4096,
# 11008, 12288, 22016 and 32000, OPT-6.7B's and BLOOM-7b1's 16384
_PATH_SPLITS = {4096: (64, 64), 11008: (128, 86), 12288: (128, 96),
                16384: (128, 128), 22016: (128, 172), 32000: (128, 250)}


@pytest.mark.parametrize("n", list(_PATH_SPLITS) + ["none"])
@pytest.mark.parametrize("transpose", [False, True])
def test_walk_path_splits(n, transpose):
    """The walk at every split of the serving path (and a = 64 with no right
    factor), both directions, a scaleWH fold, B = 1, 5, 32 and 70 (rows of
    one 70-row x: rows are independent), within 2e-2 of max |y| of the
    plain version and of quip_tpu's Pallas kernel in interpret mode."""
    if n == "none":
        signs, left, rt = _rht(64, right=False)
        n = 64
    else:
        signs, left, rt = _rht(n)
        assert (left.shape[0], rt.shape[0]) == _PATH_SPLITS[n]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((70, n)).astype(np.float32)
    vec = (signs / (rng.random(n) + 0.5)).astype(np.float32)
    xt = _t(x).to(torch.bfloat16)
    kern = np.asarray(JK3.rht_apply_fused(
        _j(x).astype(jnp.bfloat16), _j(vec), _j(left), _j(rt),
        transpose=transpose, interpret=True), np.float32)
    for B in (1, 5, 32, 70):
        plain = TK3.rht_apply_fused_ref(xt[:B], _t(vec), _t(left), _t(rt),
                                        transpose=transpose).float().numpy()
        walk = TK3.rht_walk_ref(xt[:B], _t(vec), _t(left), _t(rt),
                                transpose=transpose).float().numpy()
        top = np.abs(kern[:B]).max()
        assert np.abs(plain - kern[:B]).max() <= 2e-2 * top
        assert np.abs(walk - plain).max() <= 2e-2 * top
        assert np.abs(walk - kern[:B]).max() <= 2e-2 * top


def test_block_plan_rule():
    """32 output columns a block, so ceil(b / 32) blocks a row (one cluster,
    at most 8 for b <= 256), and ceil(a / 64) m-tiles of 64 rows."""
    assert TK3.block_plan(128, 250) == (8, 2)
    assert TK3.block_plan(128, 172) == (6, 2)
    assert TK3.block_plan(128, 96) == (3, 2)
    assert TK3.block_plan(128, 86) == (3, 2)
    assert TK3.block_plan(64, 64) == (2, 1)
    assert TK3.block_plan(64, 1) == (1, 1)
    assert TK3.block_plan(4, 125) == (4, 1)


@pytest.mark.parametrize("n,transpose", [(11008, False), (4096, True),
                                         (500, True)])
def test_prepare_layout(n, transpose):
    """prepare's operands read back through the kernel's addressing are the
    factors rounded to bf16 in their orientation, zero outside; the vec
    as x's buffer (forward: the row flat, zero in the tail) or by each
    block's 32 columns (transpose)."""
    signs, left, rt = _rht(n)
    a, b = left.shape[0], rt.shape[0]
    ops = TK3.prepare(_t(signs), _t(left), _t(rt), transpose=transpose)
    nq, mt = TK3.block_plan(a, b)
    ks, ks2 = 4 * -(-b // 64), -(-a // 16)
    bf = lambda m: torch.from_numpy(np.array(m)).to(  # noqa: E731
        torch.bfloat16)
    lop = TK3._core_read(ops.left, 0, 64 * mt, ks2, 1024 * mt)
    want = torch.zeros(64 * mt, 16 * ks2, dtype=torch.bfloat16)
    want[:a, :a] = bf(left.T if transpose else left)
    assert torch.equal(lop, want)
    ropt = torch.cat([TK3._core_read(ops.right, qs * ks * 512, 32, ks, 512)
                      for qs in range(nq)])
    want = torch.zeros(32 * nq, 16 * ks, dtype=torch.bfloat16)
    want[:b, :b] = bf(rt.T if transpose else rt)
    assert torch.equal(ropt, want)
    v = bf(signs).reshape(a, b)
    if transpose:
        got = ops.vec.reshape(nq, a, TK3.VLD)
        assert torch.equal(got[:, :, :32].permute(1, 0, 2).reshape(a, -1)
                           [:, :b], v)
        assert not got[:, :, 32:].any()
    else:
        assert ops.vec.numel() == TK3.x_len(a, b)
        assert torch.equal(ops.vec[:a * b].reshape(a, b), v)
        assert not ops.vec[a * b:].any()


def test_operands_cached_by_source():
    """operands() makes the bf16 copies once per (factors, direction) and
    returns the same tensors after; another direction has its own. A write
    in place to a factor prepares them again into those same tensors (a
    captured CUDA graph reads them there): at the next call, or at
    refresh() without one."""
    signs, left, rt = _rht(96)
    v, L, R = _t(signs), _t(left), _t(rt)
    ops = TK3.operands(v, L, R, transpose=False)
    assert TK3.operands(v, L, R, transpose=False) is ops
    other = TK3.operands(v, L, R, transpose=True)
    assert other is not ops
    held = [t.data_ptr() for t in ops + other]
    L.mul_(-1.0)
    assert TK3.operands(v, L, R, transpose=False) is ops
    assert all(torch.equal(u, w) for u, w in
               zip(ops, TK3.prepare(v, L, R, transpose=False)))
    assert not torch.equal(other.left, TK3.prepare(
        v, L, R, transpose=True).left)
    R.mul_(0.5)
    TK3.refresh()
    for got, tr in ((ops, False), (other, True)):
        assert all(torch.equal(u, w) for u, w in
                   zip(got, TK3.prepare(v, L, R, transpose=tr)))
    assert [t.data_ptr() for t in ops + other] == held


def _swh_layer(seed, m=96, d=64):
    """A random 2-bit 'rht' layer that stores scaleWH and no vin."""
    from quip_tpu_torch.models.build import random_packed
    from quip_tpu_torch.pack.format import PackedLinear
    gen = torch.Generator().manual_seed(seed)
    base = random_packed(m, d, 2, words=gen, rots=gen, device="cpu")
    rot = {s: (getattr(base, f"{s}_signs"), getattr(base, f"{s}_left"),
               getattr(base, f"{s}_right")) for s in ("u", "v")}
    return PackedLinear(base.planes, scale_b=base.scale_b,
                        scaleWH=torch.rand(d, generator=gen) + 0.5, bits=2,
                        qfn="b", proj_mode="rht", out_features=m,
                        in_features=d, rot=rot)


def test_fused_copies_follow_load_state_dict():
    """The fused path's derived state of a layer with scaleWH and no vin
    (its signs / scaleWH and K3's bf16 operands of both sides) follows a
    load_state_dict of another layer's buffers, in the tensors it had (a
    CUDA graph captured before reads those): PackedLinear refreshes them
    after the load, before any call."""
    q, new = _swh_layer(1), _swh_layer(2)
    assert not q.has_vin
    vin = TQ._fused_vin(q, q.v_signs)
    U, V = TQ.rot_to_butterflies(q)
    opv = TK3.operands(vin, V.left, V.right, transpose=False)
    opu = TK3.operands(U.signs, U.left, U.right, transpose=True)
    held = [t.data_ptr() for t in (vin,) + opv + opu]
    q.load_state_dict(new.state_dict())
    assert torch.equal(vin, new.v_signs / new.scaleWH)
    for got, want in (
            (opv, TK3.prepare(new.v_signs / new.scaleWH, new.v_left,
                              new.v_right, transpose=False)),
            (opu, TK3.prepare(new.u_signs, new.u_left, new.u_right,
                              transpose=True))):
        assert all(torch.equal(u, w) for u, w in zip(got, want))
    assert [t.data_ptr() for t in (vin,) + opv + opu] == held
    assert TQ._fused_vin(q, q.v_signs) is vin


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


def test_qlinear_fused_scalewh_without_vin(packed_layers, monkeypatch):
    """A layer that stores scaleWH and no vin: the fused branch makes signs
    / scaleWH once for the layer (so that K3's bf16 copies of it stay
    cached) and the same tensor serves the next call; the output equals the
    port's un-fused path and quip_tpu's fused branch (interpret mode)."""
    jq, _ = packed_layers
    children, aux = jq.tree_flatten()
    planes, scale, zero, scale_b, _, key, bias, rot = children
    swh = np.abs(np.random.default_rng(12).standard_normal(
        jq.in_features)).astype(np.float32) + 0.5
    jq2 = type(jq).tree_unflatten(aux, (
        planes, scale, zero, scale_b, jnp.asarray(swh), key, bias,
        {k: v for k, v in rot.items() if k != "vin"}))
    tq2 = packed_from_numpy(jax.tree.map(np.asarray, jq2), device="cpu")
    assert not tq2.has_vin and tq2.scaleWH is not None
    x = np.random.default_rng(13).standard_normal(
        (3, jq.in_features)).astype(np.float32)
    plain = TQ.qlinear_apply(tq2, torch.from_numpy(x)).numpy()
    vecs = []
    real = TQ.rht_apply_fused
    monkeypatch.setattr(TQ, "rht_apply_fused",
                        lambda *a, **k: vecs.append(a[1]) or real(*a, **k))
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    fused = TQ.qlinear_apply(tq2, torch.from_numpy(x)).numpy()
    TQ.qlinear_apply(tq2, torch.from_numpy(x))
    assert len(vecs) == 4 and vecs[2] is vecs[0]
    np.testing.assert_allclose(fused, plain, rtol=1e-4, atol=1e-4)
    monkeypatch.setenv("QUIP_KERNEL_INTERPRET", "1")
    monkeypatch.setattr(JK3, "rht_apply_fused", functools.partial(
        JK3.rht_apply_fused, interpret=True))
    want = np.asarray(j_qlinear(jq2, jnp.asarray(x)))
    np.testing.assert_allclose(fused, want, rtol=1e-3, atol=1e-3)


def test_bf16_copies_stay_out_of_checkpoints(monkeypatch, tmp_path):
    """The bf16 operands are derived state kept beside the module: after
    fused calls (and the operands of both sides made) a layer's state_dict
    holds the same tensors, a checkpoint of the model holds the same arrays
    as one written before, and the model read back from it gives, fused,
    quip_tpu's un-fused output of the same layer."""
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.pack import model as TPM
    from tests.test_torch_model import _llama_via_checkpoint
    _, jparams, tcfg, tparams = _llama_via_checkpoint()
    meta = {"model": "llama-tiny", "wbits": 2}
    TPM.save_checkpoint(str(tmp_path / "before"), tparams, meta)
    layer = tparams.blocks[0].attn.wqkv
    keys = dict(layer.state_dict())
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, layer.in_features)).astype(np.float32))
    TQ.qlinear_apply(layer, x)
    U, V = TQ.rot_to_butterflies(layer)
    TK3.operands(layer.vin, V.left, V.right, transpose=False)
    TK3.operands(U.signs, U.left, U.right, transpose=True)
    after = layer.state_dict()
    assert list(after) == list(keys)
    assert all(after[k].data_ptr() == keys[k].data_ptr()
               and torch.equal(after[k], keys[k]) for k in keys)
    TPM.save_checkpoint(str(tmp_path / "after"), tparams, meta)
    old = np.load(tmp_path / "before" / "arrays.npz")
    new = np.load(tmp_path / "after" / "arrays.npz")
    assert sorted(old.files) == sorted(new.files)
    assert all(np.array_equal(old[k], new[k]) for k in old.files)
    back = params_from_numpy(TPM.load_checkpoint(str(tmp_path / "after"))[0],
                             tcfg, device="cpu")
    got = TQ.qlinear_apply(back.blocks[0].attn.wqkv, x).numpy()
    jq = jax.tree.map(lambda p: p[0], jparams["blocks"])["attn"]["wqkv"]
    want = np.asarray(j_qlinear(jq, jnp.asarray(x.numpy()),
                                use_kernel=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
