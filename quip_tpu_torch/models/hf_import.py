"""Import Hugging Face checkpoints into the port's ``Model`` (port of
``quip_tpu/models/hf_import.py``).

A state dict (name -> tensor) maps onto the modules of models/model.py
under quip_tpu's mapping, family by family: OPT (``model.decoder.`` or
``decoder.``; learned positions, project_in/out, post-norm without a final
LayerNorm), Llama (``model.``; untied ``lm_head``) and BLOOM
(``transformer.`` or none; the fused ``query_key_value`` split from its
(H, 3, hd, D) layout, the embedding LayerNorm). HF linears store
(out, in); the port stores (in, out).

``load_hf_params`` reads a local directory only: ``*.safetensors`` (read
tensor by tensor), ``pytorch_model.bin.index.json`` shards (one shard
resident at a time) or single ``*.bin`` files. There is no hub download:
a name that is not a directory raises. Each tensor keeps its stored dtype
unless a ``dtype`` is asked for, and converts straight to it on the
target device, so nothing is inflated to f32 on the way.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping, Optional

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models.config import ModelConfig, get_config
from quip_tpu_torch.models.model import (MLP, Attention, Block, Embed, Model,
                                         Norm)


class _LazyStateDict(Mapping):
    """Read-on-demand view over a local checkpoint directory's files:
    safetensors tensor by tensor, sharded .bin files one shard at a time
    (through the index's weight map), a single .bin file at once."""

    def __init__(self, path: str):
        self._shard: Optional[str] = None
        self._loaded: Dict[str, torch.Tensor] = {}
        sts = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        index = os.path.join(path, "pytorch_model.bin.index.json")
        bins = (sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
                or sorted(glob.glob(os.path.join(path, "*.bin"))))
        self._where: Dict[str, str] = {}
        self._handles = {}
        if sts:
            from safetensors import safe_open
            for f in sts:
                self._handles[f] = safe_open(f, framework="pt")
                self._where.update(dict.fromkeys(self._handles[f].keys(), f))
        elif os.path.exists(index):
            with open(index) as fh:
                wm = json.load(fh)["weight_map"]
            self._where = {k: os.path.join(path, v) for k, v in wm.items()}
        elif bins:
            for f in bins:
                sd = torch.load(f, map_location="cpu", weights_only=True)
                self._loaded.update(sd)
                self._where.update(dict.fromkeys(sd, f))
            self._shard = "all"
        else:
            raise FileNotFoundError(
                f"no checkpoint files (*.safetensors, *.bin) under {path!r}")

    def __getitem__(self, k: str) -> torch.Tensor:
        f = self._where[k]
        if f in self._handles:
            return self._handles[f].get_tensor(k)
        if self._shard not in (f, "all"):
            self._loaded = torch.load(f, map_location="cpu",
                                      weights_only=True)
            self._shard = f
        return self._loaded[k]

    def __contains__(self, k) -> bool:
        return k in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: ModelConfig,
                         dtype=None, device="cuda") -> Model:
    """Map an HF state dict (name -> tensor or array) onto a ``Model`` on
    ``device`` (an entry point: the card by default). ``dtype`` (a torch
    dtype or its name) converts every tensor; None keeps each one's
    stored dtype."""
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)

    def g(name):
        t = torch.as_tensor(sd[name])
        return t.to(device=dev, dtype=dtype or t.dtype)

    def lin_t(name):            # HF Linear weight (out, in) -> (in, out)
        return g(name).t().contiguous()

    def ln(name):
        return Norm(g(name + ".weight"), g(name + ".bias"))

    H, hd, D = cfg.n_heads, cfg.hd, cfg.d_model
    fam = cfg.family
    if fam == "opt":
        pre = "model.decoder."
        if (pre + "embed_tokens.weight" not in sd
                and "decoder.embed_tokens.weight" in sd):
            pre = "decoder."
        proj = ((lin_t(pre + "project_in.weight"),
                 lin_t(pre + "project_out.weight"))
                if cfg.embed_proj_dim is not None else (None, None))
        emb = Embed(g(pre + "embed_tokens.weight"),
                    g(pre + "embed_positions.weight"), *proj)

        def block(i):
            b = f"{pre}layers.{i}."
            attn = {}
            for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "out_proj")):
                attn[ours] = lin_t(b + f"self_attn.{hf}.weight")
                attn["b" + ours[1:]] = g(b + f"self_attn.{hf}.bias")
            return Block(ln(b + "self_attn_layer_norm"),
                         ln(b + "final_layer_norm"), Attention(**attn),
                         MLP(w1=lin_t(b + "fc1.weight"), b1=g(b + "fc1.bias"),
                             w2=lin_t(b + "fc2.weight"),
                             b2=g(b + "fc2.bias")))

        final = ln(pre + "final_layer_norm") if cfg.do_layer_norm_before \
            else None
        head = None
    elif fam == "llama":
        pre = "model."
        emb = Embed(g(pre + "embed_tokens.weight"))

        def block(i):
            b = f"{pre}layers.{i}."
            lt = lambda n: lin_t(b + n + ".weight")  # noqa: E731
            return Block(
                Norm(g(b + "input_layernorm.weight")),
                Norm(g(b + "post_attention_layernorm.weight")),
                Attention(wq=lt("self_attn.q_proj"), wk=lt("self_attn.k_proj"),
                          wv=lt("self_attn.v_proj"),
                          wo=lt("self_attn.o_proj")),
                MLP(wg=lt("mlp.gate_proj"), wu=lt("mlp.up_proj"),
                    wd=lt("mlp.down_proj")))

        final = Norm(g(pre + "norm.weight"))
        head = lin_t("lm_head.weight")
    elif fam == "bloom":
        pre = ("transformer." if "transformer.word_embeddings.weight" in sd
               else "")
        emb = Embed(g(pre + "word_embeddings.weight"),
                    ln=ln(pre + "word_embeddings_layernorm"))

        def block(i):
            b = f"{pre}h.{i}."
            qkv = b + "self_attention.query_key_value."
            # the fused QKV rows are laid out (H, 3, hd) over (D,) inputs
            w = g(qkv + "weight").reshape(H, 3, hd, D)
            bias = g(qkv + "bias").reshape(H, 3, hd)
            part = {}
            for j, nm in enumerate("qkv"):
                part["w" + nm] = w[:, j].reshape(H * hd, D).t().contiguous()
                part["b" + nm] = bias[:, j].reshape(H * hd).contiguous()
            return Block(
                ln(b + "input_layernorm"), ln(b + "post_attention_layernorm"),
                Attention(**part, wo=lin_t(b + "self_attention.dense.weight"),
                          bo=g(b + "self_attention.dense.bias")),
                MLP(w1=lin_t(b + "mlp.dense_h_to_4h.weight"),
                    b1=g(b + "mlp.dense_h_to_4h.bias"),
                    w2=lin_t(b + "mlp.dense_4h_to_h.weight"),
                    b2=g(b + "mlp.dense_4h_to_h.bias")))

        final = ln(pre + "ln_f")
        head = None
    else:
        raise ValueError(fam)
    return Model(cfg, emb, [block(i) for i in range(cfg.n_layers)], final,
                 head)


def load_hf_params(path: str, cfg: Optional[ModelConfig] = None, dtype=None,
                   device="cuda"):
    """(Model, cfg) from the Hugging Face checkpoint files in the local
    directory ``path``; cfg defaults to the preset its last component
    names. Raises if ``path`` is not a directory."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a directory: the checkpoint files "
            f"(*.safetensors or *.bin) must be local; nothing is "
            f"downloaded")
    if cfg is None:
        cfg = get_config(os.path.basename(os.path.normpath(path)))
    return state_dict_to_params(_LazyStateDict(path), cfg, dtype,
                                device), cfg
