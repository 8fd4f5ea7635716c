"""Random-code packed models of every family (the port's counterpart of
``__graft_entry__._packed_llama`` in the JAX repo root, extended to OPT and
BLOOM).

Every linear is packed at ``bits`` (qfn-b, scale 0.02) with random plane
words and real incoherence rotations (RHT, 'rht' mode by default), in the
fused serving layout: ``wqkv`` per layer, then ``wgu`` / ``wd`` (Llama) or
``w1`` / ``w2`` (OPT, BLOOM), planes padded to ``padded_m`` out-features.
OPT and BLOOM also get their biases (``bqkv``, ``bo``, ``b1``, ``b2``), LN
scales and shifts, OPT's learned positions (and OPT-350m's projections)
and BLOOM's embedding LayerNorm, all drawn nonzero so that a dropped add
shows; their lm_head is the dense tied token table. ``head_bits`` also
packs an untied lm_head (the quantised-head serving configuration); None
keeps it dense. Everything is made directly on ``device``; no dense
projection weight is ever built.

Randomness comes from explicit ``torch.Generator``s seeded with ``seed``:
plane words, embeddings, biases and norms from a generator on ``device``,
rotations from one on the CPU (small arrays, so the same seed gives the
same rotations on every device).
"""
from __future__ import annotations

from typing import Optional

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import (MLP, Attention, Block, Embed, Model,
                                         Norm)
from quip_tpu_torch.pack.format import (PLANE_SPLITS, PackedLinear,
                                        materialize_rotation, padded_m)


def random_packed(m: int, d: int, bits: int, *, words: torch.Generator,
                  rots: torch.Generator, device, proj: str = "rht",
                  scale_b: float = 0.02) -> PackedLinear:
    """One PackedLinear with random codes and fresh rotations."""
    mp = padded_m(m, d, bits)
    planes = tuple(
        torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, mp),
                      dtype=torch.int32, generator=words, device=device)
        for fb, _ in PLANE_SPLITS[bits])
    rot = materialize_rotation(rots, m, d, proj, device=device)
    return PackedLinear(
        planes, scale_b=torch.tensor(scale_b, dtype=torch.float32,
                                     device=device),
        bits=bits, qfn="b", proj_mode=proj, out_features=m, in_features=d,
        rot=rot)


def packed_model(cfg: ModelConfig, bits: int = 2, seed: int = 0,
                 dtype=torch.bfloat16, head_bits: Optional[int] = None,
                 device="cuda", proj: str = "rht") -> Model:
    """A model of ``cfg``'s family with every projection packed at ``bits``
    (random codes). ``head_bits`` packs the lm_head too; the tied families
    (OPT, BLOOM) have none to pack and raise, as quip_tpu's quantizer does
    for ``quant_head``."""
    if head_bits and cfg.tie_word_embeddings:
        raise ValueError(
            f"head_bits={head_bits}: {cfg.family} ties its lm_head to the "
            f"token table, which must stay dense for the embedding gather")
    dev = resolve_device(device)
    words = torch.Generator(device=dev).manual_seed(seed)
    rots = torch.Generator().manual_seed(seed + 1)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    E = cfg.embed_proj_dim or D

    def pk(m, d, b=bits):
        return random_packed(m, d, b, words=words, rots=rots, device=dev,
                             proj=proj)

    def normal(*shape, std=0.02, mean=0.0):
        return torch.randn(shape, dtype=dtype, generator=words,
                           device=dev) * std + mean

    def ln():
        if cfg.norm == "rms":
            return Norm(torch.ones(D, dtype=dtype, device=dev))
        return Norm(normal(D, std=0.1, mean=1.0), normal(D, std=0.1))

    def block():
        attn = dict(wqkv=pk((H + 2 * KV) * hd, D), wo=pk(D, H * hd))
        if cfg.attn_bias:
            attn.update(bqkv=normal((H + 2 * KV) * hd), bo=normal(D))
        if cfg.act == "silu_glu":
            mlp = dict(wgu=pk(2 * F, D), wd=pk(D, F))
        else:
            mlp = dict(w1=pk(F, D), w2=pk(D, F))
            if cfg.mlp_bias:
                mlp.update(b1=normal(F), b2=normal(D))
        return Block(ln(), ln(), Attention(**attn), MLP(**mlp))

    blocks = [block() for _ in range(cfg.n_layers)]
    tokens = normal(V, E)
    emb = Embed(
        tokens,
        normal(cfg.max_seq + 2, D) if cfg.positions == "learned" else None,
        *((normal(E, D, std=E ** -0.5), normal(D, E, std=D ** -0.5))
          if cfg.embed_proj_dim is not None else (None, None)),
        ln=ln() if cfg.embed_layer_norm else None)
    if cfg.tie_word_embeddings:
        head = None
    elif head_bits:
        head = pk(V, D, head_bits)
    else:
        head = normal(D, V)
    return Model(cfg, emb, blocks, ln() if cfg.do_layer_norm_before else None,
                 head)
