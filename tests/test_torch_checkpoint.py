"""Checkpoints and packing across the two packages (llama-tiny and
opt-tiny, float32).

quip_tpu quantizes (quantize_model -> pack_quantized_model ->
save_checkpoint); the port reads the checkpoint with planes bit for bit
and every scale and rotation buffer equal, and serves the same greedy
tokens through its Engine as quip_tpu's engine. The port writes, and
quip_tpu's load_checkpoint reads every leaf equal (the proj_key slot
holds the port's marker: the rotation lives in ``rot``). The port's
pack_layer_result packs a quantize_layer result into the planes
quip_tpu's packs from its own result, and the packed layer applies the
rotation it was quantized against: qlinear_apply(packed, x) = x @ W_hatᵀ
within 1e-5 (the plain dequant-matmul runs in f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.data.calib import get_synthetic
from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.pack import format as JF
from quip_tpu.pack import model as JPM
from quip_tpu.quantize import pipeline as JP
from quip_tpu.quantize.config import QuantConfig as JQC
from quip_tpu.quantize.driver import quantize_model as jquantize_model
from quip_tpu.serve import engine as JE
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.ops.qlinear import qlinear_apply
from quip_tpu_torch.pack import format as TF
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.quantize import pipeline as TP
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_quant_core import _wh, jax_rot, t, t_cfg


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """quip_tpu's packed 2-bit llama-tiny (fused, quantized head) and its
    checkpoint directory."""
    cfg = jget_config("llama-tiny")
    p = JM.fuse_params(JM.init_params(jax.random.key(1), cfg), cfg)
    calib, _ = get_synthetic(4, 0, 32, cfg.vocab_size)
    new, art = jquantize_model(p, cfg, jnp.asarray(calib),
                               JQC.incoherence(2, "ldlq"), jax.random.key(0),
                               chunk=2, quant_head=True)
    packed = JPM.pack_quantized_model(new, cfg, art, 2)
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    JPM.save_checkpoint(path, packed, {"model": "llama-tiny"})
    return packed, path


def _leaves_equal(got_tree, want_tree, skip_uint32=False):
    gl, wl = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    for g, w in zip(gl, wl):
        if skip_uint32 and w.dtype == jnp.uint32:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_reads_quip_tpu_checkpoint(jax_ckpt):
    jpacked, path = jax_ckpt
    tree, meta = TPM.load_checkpoint(path)
    assert meta == {"model": "llama-tiny"}
    cfg = get_config("llama-tiny")
    model = params_from_numpy(tree, cfg, device="cpu")
    for li, blk in enumerate(model.blocks):
        for name, mod in (("wqkv", blk.attn.wqkv), ("wo", blk.attn.wo),
                          ("wgu", blk.mlp.wgu), ("wd", blk.mlp.wd)):
            grp = "attn" if name in ("wqkv", "wo") else "mlp"
            jq = jpacked["blocks"][grp][name]
            for p, jp in zip(mod.planes, jq.planes):
                np.testing.assert_array_equal(p.numpy(), np.asarray(jp[li]))
            np.testing.assert_array_equal(mod.scale_b.numpy(),
                                          np.asarray(jq.scale_b[li]))
            np.testing.assert_array_equal(mod.scaleWH.numpy(),
                                          np.asarray(jq.scaleWH[li]))
            np.testing.assert_array_equal(mod.u_right.numpy(),
                                          np.asarray(jq.rot["u"][2][li]))
            np.testing.assert_array_equal(mod.vin.numpy(),
                                          np.asarray(jq.rot["vin"][li]))
    np.testing.assert_array_equal(model.lm_head.plane0.numpy(),
                                  np.asarray(jpacked["lm_head"].planes[0]))
    # the dense leaves too, and the dequantized weights
    np.testing.assert_array_equal(model.embed.tokens.numpy(),
                                  np.asarray(jpacked["embed"]["tokens"]))
    ju = JPM.unpack_model(jpacked)
    tu = TPM.unpack_model(model)
    np.testing.assert_allclose(tu.blocks[1].mlp.wgu.numpy(),
                               np.asarray(ju["blocks"]["mlp"]["wgu"][1]),
                               rtol=0, atol=1e-6)


def test_port_serves_quip_tpu_checkpoint_same_tokens(jax_ckpt):
    jpacked, path = jax_ckpt
    cfg = get_config("llama-tiny")
    model = params_from_numpy(TPM.load_checkpoint(path)[0], cfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=8) for n in (5, 20, 3)]
    je = JE.Engine(jpacked, jget_config("llama-tiny"), max_batch=2,
                   max_seq=64, paged=True, hot=8, page=8)
    want = [r.generated for r in je.run(reqs)]
    te = TE.Engine(model, cfg, max_batch=2, max_seq=64, hot=8, page=8,
                   paged=True, device="cpu")
    assert [r.generated for r in te.run(reqs)] == want


def test_quip_tpu_reads_port_checkpoint(jax_ckpt, tmp_path):
    jpacked, path = jax_ckpt
    cfg = get_config("llama-tiny")
    model = params_from_numpy(TPM.load_checkpoint(path)[0], cfg,
                              device="cpu")
    out = str(tmp_path / "port")
    TPM.save_checkpoint(out, model, {"by": "port"})
    tree, meta = JPM.load_checkpoint(out)
    assert meta == {"by": "port"}
    _leaves_equal(tree, jpacked, skip_uint32=True)
    assert tree["lm_head"].proj_key is not None     # "rotated"
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    want = np.asarray(JM.forward(tree, jnp.asarray(tokens, jnp.int32),
                                 jget_config("llama-tiny")))
    got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_opt_ckpt(tmp_path_factory):
    """quip_tpu's packed 2-bit opt-tiny (fused, nonzero biases and LN
    shifts, tied head) and its checkpoint directory."""
    from tests.test_torch_families import _nonzero
    cfg = jget_config("opt-tiny")
    tree = _nonzero(jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(2), cfg)), np.random.default_rng(2))
    p = JM.fuse_params(jax.tree.map(jnp.asarray, tree), cfg)
    calib, _ = get_synthetic(4, 0, 32, cfg.vocab_size)
    new, art = jquantize_model(p, cfg, jnp.asarray(calib),
                               JQC.incoherence(2, "ldlq"), jax.random.key(0),
                               chunk=2)
    packed = JPM.pack_quantized_model(new, cfg, art, 2)
    path = str(tmp_path_factory.mktemp("jax_opt_ckpt"))
    JPM.save_checkpoint(path, packed, {"model": "opt-tiny"})
    return packed, path


def test_opt_checkpoint_serves_same_tokens(jax_opt_ckpt):
    """The port reads quip_tpu's OPT checkpoint (packed wqkv / wo / w1 /
    w2, the biases beside them, LN scales and shifts, learned positions)
    and its Engine serves quip_tpu's Engine's greedy tokens."""
    jpacked, path = jax_opt_ckpt
    cfg = get_config("opt-tiny")
    model = params_from_numpy(TPM.load_checkpoint(path)[0], cfg,
                              device="cpu")
    blk = model.blocks[1]
    assert isinstance(blk.mlp.w2, TF.PackedLinear) and blk.mlp.b2 is not None
    np.testing.assert_array_equal(
        blk.attn.bqkv.numpy(),
        np.asarray(jpacked["blocks"]["attn"]["bqkv"][1]))
    np.testing.assert_array_equal(
        model.embed.positions.numpy(),
        np.asarray(jpacked["embed"]["positions"]))
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=8) for n in (5, 20, 3)]
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8)
    want = [r.generated for r in JE.Engine(
        jpacked, jget_config("opt-tiny"), paged=True, **kw).run(reqs)]
    te = TE.Engine(model, cfg, paged=True, device="cpu", **kw)
    assert [r.generated for r in te.run(reqs)] == want


def test_quip_tpu_reads_port_opt_checkpoint(jax_opt_ckpt, tmp_path):
    """The port's OPT checkpoint has quip_tpu's tree.json layout: quip_tpu
    reads every leaf equal and its forward gives the port's logits."""
    jpacked, path = jax_opt_ckpt
    cfg = get_config("opt-tiny")
    model = params_from_numpy(TPM.load_checkpoint(path)[0], cfg,
                              device="cpu")
    out = str(tmp_path / "port_opt")
    TPM.save_checkpoint(out, model, {"by": "port"})
    with open(f"{path}/tree.json") as a, open(f"{out}/tree.json") as b:
        import json
        assert json.load(a)["treedef"] == json.load(b)["treedef"]
    tree, _ = JPM.load_checkpoint(out)
    _leaves_equal(tree, jpacked, skip_uint32=True)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    want = np.asarray(JM.forward(tree, jnp.asarray(tokens, jnp.int32),
                                 jget_config("opt-tiny")))
    got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_dense_checkpoint_both_ways(tmp_path):
    cfg = dataclasses.replace(get_config("llama-tiny"), dtype="bfloat16")
    model = TM.init_params(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
    TPM.save_checkpoint(str(tmp_path / "a"), model)
    jtree, _ = JPM.load_checkpoint(str(tmp_path / "a"))
    assert jtree["blocks"]["attn"]["wq"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jtree["blocks"]["attn"]["wq"][1], np.float32),
        model.blocks[1].attn.wq.float().numpy())
    JPM.save_checkpoint(str(tmp_path / "b"), jtree)
    tree, _ = TPM.load_checkpoint(str(tmp_path / "b"))
    back = params_from_numpy(tree, cfg, device="cpu")
    for a, b in zip(back.state_dict().values(), model.state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("mode,qfn", [("rht", "b"), ("rht_sf", "b"),
                                      ("rht_uf", "b"), (None, "a")])
def test_pack_layer_result_matches(mode, qfn):
    m, d = 24, 64
    W, H = _wh(21, m, d)
    if mode is None:
        jc = JQC(wbits=2, method="ldlq", qfn="a", blocksize=16)
    else:
        jc = JQC.incoherence(2, "ldlq", proj_mode=mode, blocksize=16)
    key = jax.random.key(9)
    jres = jax.jit(lambda w, h, k: JP.quantize_layer(w, h, jc, k))(
        jnp.asarray(W, jnp.float32), jnp.asarray(H, jnp.float32), key)
    tres = TP.quantize_layer(
        t(W.astype(np.float32)), t(H.astype(np.float32)), t_cfg(jc),
        rot=None if mode is None else jax_rot(key, m, d, jnp.float32))
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))
    want = JF.pack_layer_result(jres, 2)
    got = TF.pack_layer_result(tres, 2)
    for p, jp in zip(got.planes, want.planes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert got.has_rot == (mode is not None)
    x = torch.randn(5, d, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    y = qlinear_apply(got, x)
    ref = x @ tres.W_hat.t()
    torch.testing.assert_close(y, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(got.dequantize(), tres.W_hat, rtol=0,
                               atol=1e-5)
