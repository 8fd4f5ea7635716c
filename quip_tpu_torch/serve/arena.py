"""The flat slot arena: quip_tpu's default (non-paged) serving KV cache.

Port of ``BatchedKV``, ``_slot_attention_step`` / ``_attn_steps`` and the
arena prefill of ``quip_tpu/serve/engine.py``. The arena is one
(n_layers, max_batch, max_seq, kv_heads, hd) tensor pair; each request
owns a slot, and its rows 0..length-1 hold its keys and values. Every
decode step runs all slots (inactive ones too: their outputs are ignored),
and each attends every one of the max_seq rows under the mask
``key <= position``, so a step reads the whole arena whatever the
lengths. The paged cache (models/paged.py) reads only what is in use.

Each slot writes its new K/V row at its own length by an indexed write
(``index_put_``), where quip_tpu takes a one-hot einsum at B > 1 (a TPU
workaround; the einsum is an exact copy in f32, so the two agree bit for
bit). int8 arenas keep f32 scale planes (``model.KVCache``).

The lengths are a (B,) integer tensor on the arena's device, so a step
reads nothing back and a CUDA graph can hold it (serve/engine.py keeps
them in a fixed buffer and checks positions on the host before each
dispatch). The prefill runs a prompt at its exact length, dense over the
arena's max_seq keys with the mask ``(key <= pos) & (key < plen)`` as
quip_tpu's does; it passes no ``plen`` to the block, so the flash kernel
(K2) never runs here, as in quip_tpu.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.parallel import comm


class BatchedKV(NamedTuple):
    """k/v (n_layers, max_batch, max_seq, kv_heads, hd), float or int8;
    ks/vs (n_layers, max_batch, max_seq, kv_heads) f32, the int8 mode's
    per-(slot, position, head) scales (None for a float arena). A dp
    shard (parallel/mesh.py::init_arena_shard) holds the global slots
    ``slots`` = [lo, hi) (None: all of them)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    slots: Optional[Tuple[int, int]] = None

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_arena(cfg: ModelConfig, max_batch: int, max_seq: int,
               dtype=torch.float32, quantize: bool = False,
               device="cuda") -> BatchedKV:
    """A zeroed arena on ``device`` (an entry point: the card by default,
    raising without one); ``quantize`` stores int8 codes and f32 scales."""
    device = resolve_device(device)
    shape = (cfg.n_layers, max_batch, max_seq, cfg.kv_heads, cfg.hd)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    if not quantize:
        return BatchedKV(z(shape, dtype), z(shape, dtype))
    return BatchedKV(z(shape, torch.int8), z(shape, torch.int8),
                     z(shape[:-1], torch.float32),
                     z(shape[:-1], torch.float32))


def attn_steps(p: M.Attention, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, mask: torch.Tensor, kv: BatchedKV,
               layer: int, rows, rope_cs=None) -> torch.Tensor:
    """Attention of a (B, 1) step against the arena (quip_tpu's
    ``_attn_steps``): each slot's K/V row (after RoPE) is written into
    layer ``layer`` at ``rows`` = (slot, its length) in place, int8 arenas
    quantising it, then every slot attends all max_seq rows of its own
    under ``mask`` (B, 1, max_seq). Returns the projected output (B, 1,
    D)."""
    q, k, v = M.qkv_project(p, x, cfg)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = M.apply_rope(q, cos, sin)
        k = M.apply_rope(k, cos, sin)
    k_l, v_l = kv.k[layer], kv.v[layer]
    ks_l = vs_l = None
    if kv.quantized:
        ks_l, vs_l = kv.ks[layer], kv.vs[layer]
        k_l[rows], ks_l[rows] = M.quantize_kv(k[:, 0])
        v_l[rows], vs_l[rows] = M.quantize_kv(v[:, 0])
    else:
        k_l[rows] = k[:, 0].to(k_l.dtype)
        v_l[rows] = v[:, 0].to(v_l.dtype)
    out = M.dense_attention(q, k_l, v_l, ks_l, vs_l, positions, mask, cfg,
                            x.dtype, M.head0(p, cfg))
    return M.out_project(p, out)


def slot_attention_step(params: M.Model, cfg: ModelConfig,
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        kv: BatchedKV) -> torch.Tensor:
    """One decode token for every slot (quip_tpu's ``_slot_attention_step``):
    tokens (B, 1), lengths (B,) on the tokens' device; slot b's token takes
    position lengths[b] and its K/V row lands there. Returns logits (B, V);
    the arena is updated in place, the lengths are not (the caller advances
    them). Inactive slots (length 0) compute too.

    A dp shard of the arena (``kv.slots``; parallel/mesh.py::
    init_arena_shard, as the decode benchmark makes it) runs its own
    slots' tokens and gathers their hidden states over ``params.dp``
    before the head."""
    tokens, lengths = M.take_slots(kv.slots, tokens, lengths)
    B = tokens.shape[0]
    dev = tokens.device
    pos = lengths.to(torch.int64)
    positions = pos[:, None]                                   # (B, 1)
    mask = (torch.arange(kv.max_seq, device=dev)[None, None, :]
            <= positions[:, :, None])                          # (B, 1, L)
    rows = (torch.arange(B, device=dev), pos)
    x = M.embed(params, tokens, cfg, positions)
    cs = M.position_tables(cfg, positions)
    for l, bp in enumerate(params.blocks):
        x, _ = M.residual(
            bp, x, cfg,
            lambda h, l=l, bp=bp: (attn_steps(bp.attn, h, cfg, positions,
                                              mask, kv, l, rows, cs), None),
            lambda h, bp=bp: M.mlp(bp.mlp, h, cfg))
    if kv.slots is not None:
        x = comm.all_gather(x, params.dp, dim=0)
    return M.unembed(params, x, cfg)[:, -1, :]


def arena_prefill(params: M.Model, tokens: torch.Tensor, kv: BatchedKV,
                  slot: int, cfg: ModelConfig) -> torch.Tensor:
    """Prefill ``slot`` with a prompt (1, S) at its exact length (quip_tpu's
    arena ``prefill``): each block attends a fresh max_seq-row cache, dense
    under ``(key <= pos) & (key < S)``, in the arena's float dtype (bf16
    for an int8 arena, whose rows are quantised as they are stored). Rows
    0..S-1 of the slot are written; the rows past them are dead until the
    slot's decode steps write them. Returns the last position's logits
    (V,)."""
    _, S = tokens.shape
    L = kv.max_seq
    dev = tokens.device
    M.check_positions(params, cfg, S)
    positions = torch.arange(S, device=dev)[None]
    key = torch.arange(L, device=dev)
    mask = ((key[None, None, :] <= positions[:, :, None])
            & (key[None, None, :] < S))                        # (1, S, L)
    x = M.embed(params, tokens, cfg, positions)
    cs = M.position_tables(cfg, positions)
    fpdt = torch.bfloat16 if kv.quantized else kv.k.dtype
    shape = (1, L, cfg.kv_heads, cfg.hd)
    for l, bp in enumerate(params.blocks):
        cache = M.KVCache(torch.zeros(shape, dtype=fpdt, device=dev),
                          torch.zeros(shape, dtype=fpdt, device=dev),
                          torch.zeros((), dtype=torch.int32))
        x, cache = M.block_apply(bp, x, cfg, positions, mask, rope_cs=cs,
                                 cache=cache)
        k, v = cache.k[0, :S], cache.v[0, :S]
        if kv.quantized:
            k, kv.ks[l, slot, :S] = M.quantize_kv(k)
            v, kv.vs[l, slot, :S] = M.quantize_kv(v)
        kv.k[l, slot, :S] = k.to(kv.k.dtype)
        kv.v[l, slot, :S] = v.to(kv.v.dtype)
    return M.unembed(params, x[:, S - 1:], cfg)[0, -1]
