"""Hugging Face import in the port (models/hf_import.py) against
transformers and against quip_tpu's own import, offline: tiny random
transformers models built from a config (no download), as
tests/test_hf_import.py does for quip_tpu. Logits within 2e-3 of max
|logit| of transformers' forward (that file's tolerance); the imported
tree equals quip_tpu's ``state_dict_to_params`` leaf for leaf."""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from quip_tpu.models.config import ModelConfig as JConfig
from quip_tpu.models.hf_import import state_dict_to_params as j_import
from quip_tpu_torch.cli import common
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.hf_import import (load_hf_params,
                                             state_dict_to_params)
from quip_tpu_torch.pack.model import model_tree

transformers = pytest.importorskip("transformers")


def _opt(post_norm=False):
    hf = transformers.OPTConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2, ffn_dim=64,
        num_attention_heads=4, max_position_embeddings=64,
        word_embed_proj_dim=16 if post_norm else 32,
        do_layer_norm_before=not post_norm)
    kw = dict(embed_proj_dim=16, do_layer_norm_before=False) \
        if post_norm else {}
    return (transformers.OPTForCausalLM, hf,
            dict(family="opt", vocab_size=128, d_model=32, n_layers=2,
                 n_heads=4, d_ff=64, max_seq=64, **kw))


def _llama():
    hf = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        tie_word_embeddings=False)
    return (transformers.LlamaForCausalLM, hf,
            dict(family="llama", vocab_size=128, d_model=32, n_layers=2,
                 n_heads=4, n_kv_heads=2, d_ff=64, positions="rope",
                 norm="rms", act="silu_glu", tie_word_embeddings=False,
                 attn_bias=False, mlp_bias=False, max_seq=64,
                 norm_eps=hf.rms_norm_eps))


def _bloom():
    hf = transformers.BloomConfig(
        vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
        apply_residual_connection_post_layernorm=False)
    return (transformers.BloomForCausalLM, hf,
            dict(family="bloom", vocab_size=128, d_model=32, n_layers=2,
                 n_heads=4, d_ff=128, positions="alibi", norm="ln",
                 act="gelu", embed_layer_norm=True, max_seq=64))


FAMILIES = {"opt": _opt, "opt-350m-style": lambda: _opt(post_norm=True),
            "llama": _llama, "bloom": _bloom}


def _hf(name, seed=0):
    cls, hf_cfg, kw = FAMILIES[name]()
    torch.manual_seed(seed)
    with torch.no_grad():
        model = cls(hf_cfg).eval()
        # nonzero biases and norm shifts (transformers initialises some
        # to zero, which would hide a dropped add)
        for k, v in model.state_dict().items():
            if k.endswith(".bias"):
                v.normal_(0.0, 0.1)
    return model, ModelConfig(**kw), JConfig(**kw)


def _close(got, want, frac=2e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= frac * scale


def _leaves_equal(port_tree, jax_tree):
    mine = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    theirs = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(path))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_and_tree_match(name):
    hf, cfg, jcfg = _hf(name)
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    model = state_dict_to_params(sd, cfg, device="cpu")
    tokens = torch.tensor([[1, 5, 9, 2, 7, 3]])
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
        got = model(tokens).numpy()
    _close(got, want)
    jtree = j_import({k: v.numpy() for k, v in sd.items()}, jcfg,
                     dtype="float32")
    _leaves_equal(model_tree(model), jtree)


def test_stored_dtype_is_kept():
    hf, cfg, _ = _hf("opt")
    sd = {k: v.detach().to(torch.bfloat16) for k, v in hf.state_dict().items()}
    model = state_dict_to_params(sd, cfg, device="cpu")
    assert {t.dtype for t in model.buffers()} == {torch.bfloat16}
    f16 = state_dict_to_params(sd, cfg, dtype="float16", device="cpu")
    assert {t.dtype for t in f16.buffers()} == {torch.float16}


@pytest.mark.parametrize("layout", ["safetensors", "bin", "sharded_bin"])
def test_load_local_directory(tmp_path, layout):
    """load_hf_params on a local directory of each file layout."""
    hf, cfg, _ = _hf("bloom", seed=1)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    d = tmp_path / "bloom-tiny"
    d.mkdir()
    if layout == "safetensors":
        from safetensors.torch import save_file
        save_file(sd, str(d / "model.safetensors"))
    elif layout == "bin":
        torch.save(sd, str(d / "pytorch_model.bin"))
    else:
        keys = sorted(sd)
        shards = {"pytorch_model-00001-of-00002.bin": keys[::2],
                  "pytorch_model-00002-of-00002.bin": keys[1::2]}
        wm = {}
        for fname, ks in shards.items():
            torch.save({k: sd[k] for k in ks}, str(d / fname))
            wm.update(dict.fromkeys(ks, fname))
        (d / "pytorch_model.bin.index.json").write_text(
            json.dumps({"weight_map": wm}))
    model, got_cfg = load_hf_params(str(d), cfg, device="cpu")
    assert got_cfg is cfg
    tokens = torch.tensor([[3, 7, 1, 9]])
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
    _close(model(tokens).detach().numpy(), want)


def test_cli_weights_directory(tmp_path):
    """The CLIs' ``--weights <dir>`` (cli/common.load_model): an OPT model
    at opt-tiny's widths, saved as safetensors, loads under the preset at
    the CLI's dtype."""
    from safetensors.torch import save_file
    hf_cfg = transformers.OPTConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, ffn_dim=128,
        num_attention_heads=4, max_position_embeddings=128,
        word_embed_proj_dim=64)
    torch.manual_seed(2)
    with torch.no_grad():
        hf = transformers.OPTForCausalLM(hf_cfg).eval()
    save_file({k: v.detach().clone()
               for k, v in hf.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    args = p.parse_args(["opt-tiny", "--weights", str(tmp_path), "--device",
                         "cpu"])
    model, cfg = common.load_model(args)
    assert cfg.family == "opt" and cfg.dtype == "float32"
    tokens = torch.tensor([[3, 70, 1, 9, 200]])
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
        got = model(tokens).numpy()
    _close(got, want)


def test_not_a_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="must be local"):
        load_hf_params("facebook/opt-125m", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        load_hf_params(str(tmp_path / "empty"),
                       ModelConfig(family="opt", vocab_size=8, d_model=8,
                                   n_layers=1, n_heads=1, d_ff=8),
                       device="cpu")
