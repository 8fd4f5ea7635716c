"""Activation quantization wrapper (port of ``quip_tpu/ops/actquant.py``;
reference ActQuantWrapper / add_actquant,
zeroShot/models/quant.py:134-177).

:class:`ActQuant` is an ``nn.Module`` wrapping any linear (a dense (in,
out) tensor or a ``PackedLinear``) whose inputs it fake-quantizes on a
per-fan-in-channel qfn-a grid (``scale`` / ``zero`` buffers of
in_features). ``ops.qlinear.linear_apply`` dispatches on it, so a wrapped
model runs through the forward, both caches and the engine's graphs
unchanged. As the reference's ``ready()``: while every scale is zero (not
calibrated yet) the wrapper is the identity; the test is a device-side
select, never a host sync. The port's blocks are one module a layer, so
the grids carry no layer axis (quip_tpu stacks them for its scan).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from quip_tpu_torch.core import grid
from quip_tpu_torch.pack.format import PackedLinear


def quantize_activations(x: torch.Tensor, bits: int = 8,
                         per_token: bool = True,
                         sym: bool = True) -> torch.Tensor:
    """Fake-quant x on a 2**bits uniform grid (the stateless one-shot
    form): one scale per leading position (row) with ``per_token``, else
    one for the whole tensor."""
    maxq = 2 ** bits - 1
    red = dict(dim=-1, keepdim=True) if per_token else {}
    if sym:
        amax = torch.clamp(torch.amax(x.abs(), **red), min=1e-8)
        scale = (2 * amax) / maxq
        zero = (maxq + 1) / 2
    else:
        xmin = torch.clamp(torch.amin(x, **red), max=0.0)
        xmax = torch.clamp(torch.amax(x, **red), min=0.0)
        scale = torch.clamp(xmax - xmin, min=1e-8) / maxq
        zero = torch.round(-xmin / scale)
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


def quantize_conv2d_weight(W4d: torch.Tensor, H: torch.Tensor, cfg,
                           rot=None, gen=None):
    """Quantize a Conv2d weight (O, I, Kh, Kw) by flattening the receptive
    field (method.py:88-89 W.flatten(1); H over the unfolded patches).
    Returns (the quantized weight in the 4-D shape, the layer result)."""
    from quip_tpu_torch.quantize.pipeline import quantize_layer
    res = quantize_layer(W4d.reshape(W4d.shape[0], -1), H, cfg, rot=rot,
                         gen=gen)
    return res.W_hat.reshape(W4d.shape), res


def _in_features(leaf) -> int:
    if isinstance(leaf, PackedLinear):
        return leaf.in_features
    return leaf.shape[-2]


class ActQuant(nn.Module):
    """Activation-quantizing wrapper around a linear. ``scale`` / ``zero``:
    (in_features,) qfn-a grid; all-zero scales mean "not calibrated", and
    the forward is then the identity. ``maxq`` = 2**bits - 1."""

    def __init__(self, inner, scale: torch.Tensor, zero: torch.Tensor,
                 maxq: float):
        super().__init__()
        if isinstance(inner, nn.Module):
            self.inner = inner
        else:
            self.register_buffer("inner", inner)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.maxq = float(maxq)

    @property
    def bits(self) -> int:
        return int(round(math.log2(self.maxq + 1)))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        ready = torch.all(self.scale != 0)
        scale = torch.where(self.scale == 0, 1.0, self.scale).to(x.dtype)
        q = grid.quantize_qfna(x, scale, self.zero.to(x.dtype), self.maxq)
        return torch.where(ready, q, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from quip_tpu_torch.ops.qlinear import linear_apply
        return linear_apply(self, x)


def wrap_actquant(leaf, bits: int = 8) -> ActQuant:
    """Wrap one linear, uncalibrated (the identity until calibrated)."""
    d = _in_features(leaf)
    dev = (leaf.plane0 if isinstance(leaf, PackedLinear) else leaf).device
    z = lambda: torch.zeros(d, dtype=torch.float32, device=dev)  # noqa: E731
    return ActQuant(leaf, z(), z(), float(2 ** bits - 1))


def find_params(aq: ActQuant, x: torch.Tensor, sym: bool = False,
                mse: bool = False) -> ActQuant:
    """A wrapper calibrated from recorded inputs x (..., in_features): the
    per-channel min/max grid of grid.find_params_qfna_act (the
    reference's external find_params call). ``aq`` is left as it was."""
    g = grid.find_params_qfna_act(
        x.reshape(-1, x.shape[-1]).to(torch.float32), aq.bits, sym=sym,
        mse=mse)
    return ActQuant(aq.inner, g.scale.reshape(-1), g.zero.reshape(-1),
                    aq.maxq)


def add_actquant(params, cfg, bits: int = 8):
    """A Model with every block linear (and the untied lm_head) wrapped in
    an uncalibrated ActQuant (the reference's ``add_actquant`` walk);
    everything else is shared with ``params``."""
    from quip_tpu_torch.models import model as M
    specs = M.linear_specs(cfg, fused=params.blocks[0].attn.fused)
    blocks = [M.replace_linears(b, specs,
                                lambda _, w: wrap_actquant(w, bits))
              for b in params.blocks]
    head = params.lm_head
    if not cfg.tie_word_embeddings and head is not None:
        head = wrap_actquant(head, bits)
    return M.Model(cfg, params.embed, blocks, params.final_ln, head)


def calibrate_actquant(params, cfg, tokens: torch.Tensor, sym: bool = False,
                       mse: bool = False):
    """A Model whose ActQuant wrappers are calibrated from one forward over
    ``tokens`` (B, S): each wrapper's grid from the inputs its linear
    records (block_apply's taps; the head's from its true input)."""
    from quip_tpu_torch.models import model as M
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    mask = M.causal_mask(B, S, dev)
    cs = M.position_tables(cfg, positions)
    specs = M.linear_specs(cfg, fused=params.blocks[0].attn.fused)
    x = M.embed(params, tokens, cfg, positions)
    blocks = []
    with torch.no_grad():
        for b in params.blocks:
            y, _, taps = M.block_apply(b, x, cfg, positions, mask,
                                       rope_cs=cs, with_taps=True)
            blocks.append(M.replace_linears(
                b, specs, lambda spec, w, taps=taps: find_params(
                    w, taps[spec.tap], sym, mse)
                if isinstance(w, ActQuant) else w))
            x = y
        head = params.lm_head
        if isinstance(head, ActQuant):
            head = find_params(head, M.head_input(params, x, cfg), sym, mse)
    return M.Model(cfg, params.embed, blocks, params.final_ln, head)
