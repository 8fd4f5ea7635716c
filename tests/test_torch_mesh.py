"""The port's sharding rules, meshes and communication model
(parallel/mesh.py, comm.py, pipeline.py) against quip_tpu's, and the two
CLIs that start ranks themselves (cli/commreport.py, cli/quantize --dp).

Specs: every leaf's (axis -> mesh axis) tuple against quip_tpu's
``param_specs`` / ``split_specs`` / ``paged_cache_specs`` on the same
llama-tiny and opt-tiny trees (packed and dense), with the port's stated
differences: the column biases beside packed linears and the paged
cursors stay whole (parallel/mesh.py's docstring says why). Local shards
on virtual meshes (no process group): shapes, the fused dense split part
by part, a qfn-a shard's scales, the m_p % tp error. The ring model, the
GPipe model and the scaling estimate are quip_tpu's arithmetic.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quip_tpu.models import get_config as jget_config
from quip_tpu.models import paged as JPG
from quip_tpu.pack import model as JPM
from quip_tpu.pack.format import PackedLinear as JPackedLinear
from quip_tpu.parallel import comm as jcomm
from quip_tpu.parallel import mesh as JMESH
from quip_tpu.parallel.pipeline import pipeline_comm_bytes as jpipe_bytes
from quip_tpu_torch.cli import commreport as TCR
from quip_tpu_torch.cli import quantize as TQCLI
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models import paged as PG
from quip_tpu_torch.models.build import packed_model
from quip_tpu_torch.ops.qlinear import TPLinear
from quip_tpu_torch.pack import model as TPM
from quip_tpu_torch.pack.format import PackedLinear, pack_codes
from quip_tpu_torch.parallel import comm
from quip_tpu_torch.parallel import mesh as PM
from quip_tpu_torch.parallel.pipeline import pipeline_comm_bytes

# the port's stated differences, leaf name -> its spec and quip_tpu's
# (per layer): a packed block's column biases stay whole
PACKED_BIASES = {"bq", "bk", "bv", "bqkv", "b1"}


def _norm(spec) -> tuple:
    s = tuple(spec)
    while s and s[-1] is None:
        s = s[:-1]
    return s


def _flat_jax(tree, prefix="") -> dict:
    """quip_tpu's spec tree as {port leaf path: normalized spec}."""
    out = {}
    if isinstance(tree, JPackedLinear):
        for i, p in enumerate(tree.planes):
            out[f"{prefix}.planes.{i}"] = _norm(p)
        for f in ("scale", "zero", "scale_b", "scaleWH", "bias"):
            if getattr(tree, f) is not None:
                out[f"{prefix}.{f}"] = _norm(getattr(tree, f))
        if tree.rot is not None:
            rots = {_norm(p) for p in jax.tree.leaves(
                tree.rot, is_leaf=lambda x: isinstance(x, P))}
            assert len(rots) == 1, rots
            out[f"{prefix}.rot"] = rots.pop()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_jax(v, f"{prefix}.{k}" if prefix else k))
    elif tree is not None:
        out[prefix] = _norm(tree)
    return out


def _model(name: str, packed: bool):
    cfg = get_config(name)
    if packed:
        head = None if cfg.tie_word_embeddings else 2
        model = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
                             head_bits=head, device="cpu")
    else:
        model = M.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    with tempfile.TemporaryDirectory() as path:
        TPM.save_checkpoint(path, model, {"model": name})
        jparams, _ = JPM.load_checkpoint(path)
    return model, cfg, jparams, jget_config(name)


def _check_specs(port: dict, jax_: dict, packed: bool):
    assert set(port) == set(jax_), set(port) ^ set(jax_)
    for k, s in port.items():
        leaf = k.split(".")[-1]
        if packed and leaf in PACKED_BIASES:
            assert "tp" not in s and jax_[k][-1] == "tp", (k, s, jax_[k])
        else:
            assert s == jax_[k], (k, s, jax_[k])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("name", ["llama-tiny", "opt-tiny"])
def test_param_specs_match_quip_tpu(name, packed):
    """The stacked specs (quip_tpu's param_specs), with and without a
    'pp' layer axis."""
    model, cfg, jparams, jcfg = _model(name, packed)
    for la in (None, "pp"):
        port = PM.param_specs(model, cfg, layer_axis=la)
        want = _flat_jax(JMESH.param_specs(jparams, jcfg, layer_axis=la))
        _check_specs(port, want, packed)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("name", ["llama-tiny", "opt-tiny"])
def test_split_specs_match_quip_tpu(name, packed):
    """The per-layer specs (quip_tpu's split_specs of paged.as_split)."""
    model, cfg, jparams, jcfg = _model(name, packed)
    split = JMESH.split_specs(JPG.as_split(jparams), jcfg)
    want = _flat_jax(split.misc)
    for i, layer in enumerate(split.layers):
        want.update(_flat_jax(layer, f"blocks.{i}"))
    _check_specs(PM.split_specs(model, cfg), want, packed)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_cache_specs_match_quip_tpu(quantized):
    cfg = get_config("llama-tiny")
    caches = PG.init_paged(4, 32, cfg, quantized=quantized, hot=8,
                           device="cpu")
    jcaches = JPG.init_paged(4, 32, jget_config("llama-tiny"),
                             quantized=quantized, hot=8)
    want = JMESH.paged_cache_specs(jcaches)
    port = PM.paged_cache_specs(caches)
    for f, s in port.items():
        if f in ("base", "hot_len"):           # whole on every rank
            assert s == () and _norm(getattr(want, f)) == ("dp",)
        else:
            assert s == _norm(getattr(want, f)), f
    assert set(port) == {f for f in want._fields
                         if getattr(want, f) is not None}
    assert PM.cache_specs(cfg) == _norm(JMESH.cache_specs(jget_config(
        "llama-tiny")))
    assert PM.data_spec() == _norm(JMESH.data_spec())
    assert PM.seq_sharded_spec() == _norm(JMESH.seq_sharded_spec())


@pytest.mark.parametrize("tp", [2, 4])
def test_local_shards(tp):
    """Each rank's shard of every leaf: a packed linear's planes are its
    contiguous (nwords, m_p / tp) columns (out_features kept whole), a
    dense column-parallel weight its columns (a fused one part by part:
    its own heads of q, k and v), a row-parallel one its rows; the norms
    and the embedding are the same tensors; the paged cache its slots and
    kv heads, the prefix its kv heads."""
    cfg = get_config("llama-tiny")
    packed = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
                          head_bits=2, device="cpu")
    dense = M.fuse_params(M.init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu"), cfg)
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    for r in range(tp):
        mesh = PM.make_mesh(1, tp, rank=r, device="cpu")
        sp = PM.shard_params(packed, cfg, mesh)
        assert sp.embed is packed.embed and sp.lm_head is packed.lm_head
        for name in ("wqkv", "wo"):
            q = getattr(packed.blocks[0].attn, name)
            t = getattr(sp.blocks[0].attn, name)
            assert isinstance(t, TPLinear) and t.layout == "gather"
            m_p = q.planes[0].shape[-1]
            k = m_p // tp
            assert torch.equal(t.inner.planes[0],
                               q.planes[0][:, r * k:(r + 1) * k])
            assert t.inner.out_features == q.out_features
        sd = PM.shard_params(dense, cfg, mesh)
        w, t = dense.blocks[0].attn.wqkv, sd.blocks[0].attn.wqkv
        assert t.layout == "col"
        parts = torch.split(w, [H * hd, KV * hd, KV * hd], dim=-1)
        want = torch.cat([p[:, r * p.shape[1] // tp:
                            (r + 1) * p.shape[1] // tp] for p in parts], -1)
        assert torch.equal(t.inner, want)
        wo = sd.blocks[0].attn.wo
        assert wo.layout == "row" and wo.inner.shape == (H * hd // tp,
                                                          cfg.d_model)
        caches = PG.init_paged(2, 32, cfg, quantized=True, hot=8,
                               device="cpu")
        sc = PM.shard_paged(caches, PM.make_mesh(2, tp, rank=r,
                                                 device="cpu"))
        assert sc.k.shape == (cfg.n_layers, 1, 32, KV // tp, hd)
        assert sc.ks.shape == (cfg.n_layers, 1, 32, KV // tp)
        assert sc.slots == ((0, 1) if r < tp else (1, 2))
        assert sc.base.shape == (2,)


def test_sharded_load_from_quip_tpu():
    """convert.params_from_numpy(..., mesh=) loads quip_tpu's tree as this
    rank's shard: each rank's wqkv planes are its columns of the whole
    load's."""
    from quip_tpu_torch.convert import params_from_numpy
    model, cfg, jparams, _ = _model("llama-tiny", True)
    tree = jax.tree.map(np.asarray, jparams)
    whole = params_from_numpy(tree, cfg, device="cpu")
    for r in range(2):
        part = params_from_numpy(tree, cfg, device="cpu",
                                 mesh=PM.make_mesh(1, 2, rank=r,
                                                   device="cpu"))
        w = whole.blocks[1].attn.wqkv.planes[0]
        k = w.shape[-1] // 2
        assert torch.equal(part.blocks[1].attn.wqkv.inner.planes[0],
                           w[:, r * k:(r + 1) * k])
        assert part.tp.index == r and part.lm_head is not None


def test_qfn_a_shard_and_mp_error():
    """A qfn-a linear's scale and zero shard with its columns: the joined
    shards' products are the whole layer's. m_p not divisible by tp
    raises with the shapes."""
    from quip_tpu_torch.kernels.dequant_matmul import dequant_matmul
    g = torch.Generator().manual_seed(0)
    m, d = 48, 64
    codes = torch.randint(0, 4, (m, d), generator=g)
    q = PackedLinear(pack_codes(codes, 2), torch.rand(m, generator=g),
                     torch.rand(m, generator=g) * 3, bits=2, qfn="a",
                     proj_mode="none", out_features=m, in_features=d)
    x = torch.randn(3, d, generator=g)
    whole = dequant_matmul(x, q.planes, q.scale, q.zero, bits=2, qfn="a")
    joined = []
    for r in range(4):
        s = PM.shard_packed(q, comm.Axis("tp", 4, r, (0, 1, 2, 3)), "w")
        assert s.scale.shape == (m // 4,) and s.planes[0].shape[-1] == m // 4
        joined.append(dequant_matmul(x, s.planes, s.scale, s.zero, bits=2,
                                     qfn="a"))
    torch.testing.assert_close(torch.cat(joined, -1), whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"m_p = 48 .* not divisible by "
                                         r"tp = 5"):
        PM.shard_packed(q, comm.Axis("tp", 5, 0, tuple(range(5))), "w")


def test_meshes_and_hybrid_checks():
    """Mesh coordinates and axes (tp contiguous), and make_hybrid_mesh's
    layout and checks, whose messages are quip_tpu's asserts'."""
    m = PM.make_mesh(2, 2, rank=3, device="cpu")
    assert m.coords == {"dp": 1, "tp": 1} and m.size == 4
    assert m.axis("dp").ranks == (1, 3) and m.axis("tp").ranks == (2, 3)
    assert m.axis("pp").size == 1
    pt = PM.make_mesh_pp_tp(2, 2, rank=2, device="cpu")
    assert pt.coords == {"pp": 1, "tp": 0}
    assert PM.make_pp_mesh(4, rank=1, device="cpu").axis("pp").index == 1
    np.testing.assert_array_equal(PM.hybrid_grid(4, 2, 8, 4),
                                  np.arange(8).reshape(4, 2))
    np.testing.assert_array_equal(PM.hybrid_grid(2, None, 8, 4),
                                  np.arange(8).reshape(2, 4))
    with pytest.raises(ValueError, match="tp=3 must divide per-host "
                                         "device count 4"):
        PM.hybrid_grid(2, 3, 8, 4)
    with pytest.raises(ValueError, match=r"dp=3 != hosts\(2\)"):
        PM.hybrid_grid(3, 2, 8, 4)
    with pytest.raises(ValueError, match="ranks, but the process group"):
        PM.make_mesh(2, 2)


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "collective-permute",
                                  "all-to-all", "broadcast"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_wire_bytes_match_quip_tpu(kind, group):
    assert comm._wire_bytes(kind, 12288, group) == jcomm._wire_bytes(
        kind, 12288, group)


def test_pipeline_and_scaling_models_match_quip_tpu():
    cfg, jcfg = get_config("llama-2-7b"), jget_config("llama-2-7b")
    for mb, pp in ((2, 2), (8, 4), (4, 1)):
        assert pipeline_comm_bytes(cfg, 8, 2048, mb, pp) == jpipe_bytes(
            jcfg, 8, 2048, mb, pp)
    rep = {"total_wire_bytes": 6.0e6}
    for kw in (dict(hbm_gbps=720.0, ici_gbps=90.0),
               dict(hbm_gbps=3350.0, ici_gbps=450.0)):
        assert comm.scaling_estimate(
            rep, compute_bytes_per_chip=int(4e8), **kw) == \
            jcomm.scaling_estimate(rep, compute_bytes_per_chip=int(4e8),
                                   **kw)
    # the port's defaults are the H100 data sheet's rates
    est = comm.scaling_estimate(rep, compute_bytes_per_chip=int(3.35e9))
    assert est["t_hbm_us"] == pytest.approx(1000.0)


def test_commreport_cli(capsys):
    """cli/commreport on four gloo ranks (tp 2 x dp 2) at llama-tiny's
    widths: quip_tpu's keys, 5 collectives a layer by the design (the
    fused qkv output, the attention output, wo, gate-up and wd gathered
    over tp) and one gather of the hidden states over dp a step."""
    out = TCR.main(["--model", "llama-tiny", "--tp", "2", "--dp", "2",
                    "--pp", "2", "--microbatches", "2", "--prefill_seq",
                    "64"])
    import json
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(out))
    assert set(out) == {"config", "tp_decode", "pp_prefill_gpipe",
                        "not_modeled"}
    d = out["tp_decode"]
    assert set(d) == {"collectives_per_step", "wire_bytes_per_step",
                      "per_layer", "per_kind_2layer", "largest",
                      "scaling_estimate"}
    assert d["per_layer"]["collectives"] == 5
    assert d["collectives_per_step"] == 5 * 2 + 1
    assert d["per_kind_2layer"]["all-gather"]["count"] == 11
    assert out["config"]["backend"] == "gloo"
    assert out["pp_prefill_gpipe"] == jpipe_bytes(
        jget_config("llama-tiny"), 2, 64, 2, 2)


def test_quantize_cli_dp_mesh(tmp_path, capsys):
    """quip_tpu's test_quantize_cli_dp_mesh (tests/test_cli.py): --dp 2
    calibrates on two gloo ranks and rank 0 saves a working checkpoint;
    each linear's proxy loss is --dp 1's up to the f32 sum order of the
    Hessian (1e-4 relative), and --dp keeps quip_tpu's checks."""
    ck = str(tmp_path / "dp_ck")
    argv = ["opt-tiny", "synthetic", "--wbits", "2", "--quant", "ldlq",
            "--incoh_processing", "--nsamples", "8", "--seqlen", "32",
            "--chunk", "8", "--device", "cpu"]
    _, art2 = TQCLI.main(argv + ["--dp", "2", "--packed", "--save", ck])
    assert "saved checkpoint" in capsys.readouterr().out
    tree, meta = TPM.load_checkpoint(ck)
    assert meta["wbits"] == 2
    _, art1 = TQCLI.main(argv)
    for k, e in art1.errors.items():
        assert art2.errors[k] == pytest.approx(e, rel=1e-4), k
    with pytest.raises(SystemExit):
        TQCLI.main(argv[:-6] + ["--nsamples", "7", "--chunk", "7", "--dp",
                                "2", "--device", "cpu"])
    assert "must be divisible by --dp 2" in capsys.readouterr().err
