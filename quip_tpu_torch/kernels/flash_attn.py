"""K2: blockwise (flash) causal self-attention for prefill.

``flash_prefill_bshd`` replaces the Pallas kernel
``quip_tpu/kernels/flash_attn.py`` (``flash_prefill`` -> ``_kernel``,
wrapper ``flash_prefill_bshd``) with the hand-written CUDA kernel in
``csrc/flash_attn.cu``. It reads the model's (B, S, H, hd) layout in
place and masks the ragged last tile itself, so any S works without the
256-padding. The kernel is bound by its two products on the CUDA cores;
its design note is in the source.

Semantics: key j is valid for query i iff j <= i and j < plen[b]; GQA head
h reads KV head h // (H // KV); output acc / max(l, 1e-30) (padded query
rows give finite values, garbage by contract).

Dispatch goes by device: CUDA tensors launch the kernel (or raise), CPU
tensors take ``flash_prefill_ref``, a dense f32 masked softmax.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from quip_tpu_torch.kernels import _build

launches = 0          # kernel launches, read by callers

_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = _build.load("flash_attn").quip_flash_prefill
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      plen: Optional[torch.Tensor], *,
                      scale: float) -> torch.Tensor:
    """Plain version: dense f32 causal attention with the kernel's mask.
    q (B, S, H, hd); k/v (B, S, KV, hd); returns (B, S, H, hd) in q's
    dtype."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,blhd->bhsl", q.to(torch.float32), kf) * scale
    if plen is None:
        plen = torch.full((B,), S, dtype=torch.int32, device=q.device)
    i = torch.arange(S, device=q.device)
    valid = ((i[None, :] <= i[:, None])[None]
             & (i[None, None, :] < plen.to(q.device)[:, None, None]))
    logits = torch.where(valid[:, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhsl,blhd->bshd", probs, vf).to(q.dtype)


def flash_prefill_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       plen: Optional[torch.Tensor] = None, *,
                       scale: float) -> torch.Tensor:
    """Causal blockwise attention in the model's layout: q (B, S, H, hd),
    k/v (B, S, KV, hd), plen (B,) valid key lengths (None = S)."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, plen, scale=scale)
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} must be bf16 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd):
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hd != 128 or H % KV:
        raise ValueError(f"flash_prefill: needs hd == 128 and H % KV == 0, "
                         f"got hd={hd}, H={H}, KV={KV}")
    if plen is None:
        plen = torch.full((B,), S, dtype=torch.int32, device=q.device)
    plen = plen.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(plen.shape) != (B,):
        raise ValueError(f"flash_prefill: plen must be ({B},)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), plen.data_ptr(),
                   out.data_ptr(), B, S, H, KV, hd, float(scale),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_prefill")
    launches += 1
    return out
