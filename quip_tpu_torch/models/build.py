"""Random-code packed Llama (the port's counterpart of
``__graft_entry__._packed_llama`` in the JAX repo root).

Every linear is packed at ``bits`` (qfn-b, scale 0.02) with random plane
words and real incoherence rotations (RHT, 'rht' mode by default), in the
fused serving layout: ``wqkv`` and ``wgu`` per layer, planes padded to
``padded_m`` out-features. ``head_bits`` also packs the lm_head (the
quantised-head serving configuration); None keeps it dense. Everything is
made directly on ``device``; no dense projection weight is ever built.

Randomness comes from explicit ``torch.Generator``s seeded with ``seed``:
plane words and embeddings from a generator on ``device``, rotations from
one on the CPU (small arrays, so the same seed gives the same rotations on
every device).
"""
from __future__ import annotations

from typing import Optional

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import MLP, Attention, Block, Model
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


def packed_llama(cfg: ModelConfig, bits: int = 2, seed: int = 0,
                 dtype=torch.bfloat16, head_bits: Optional[int] = None,
                 device="cuda", proj: str = "rht") -> Model:
    """A Llama with every projection packed at ``bits`` (random codes)."""
    dev = resolve_device(device)
    words = torch.Generator(device=dev).manual_seed(seed)
    rots = torch.Generator().manual_seed(seed + 1)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd

    def pk(m, d, b=bits):
        return random_packed(m, d, b, words=words, rots=rots, device=dev,
                             proj=proj)

    ones = lambda: torch.ones(D, dtype=dtype, device=dev)  # noqa: E731
    blocks = [
        Block(ones(), ones(),
              Attention(wqkv=pk((H + 2 * KV) * hd, D), wo=pk(D, H * hd)),
              MLP(wgu=pk(2 * F, D), wd=pk(D, F)))
        for _ in range(cfg.n_layers)]
    embed = torch.randn((V, D), dtype=dtype, generator=words,
                        device=dev) * 0.02
    if head_bits:
        head = pk(V, D, head_bits)
    else:
        head = torch.randn((D, V), dtype=dtype, generator=words,
                           device=dev) * 0.02
    return Model(cfg, embed, blocks, ones(), head)
