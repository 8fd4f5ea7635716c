"""Turn a quip_tpu param tree (as numpy) into the port's modules.

Input is the tree as ``jax.tree.map(np.asarray, params)`` leaves it:
nested dicts of numpy arrays, with quip_tpu ``PackedLinear`` nodes whose
children became numpy. Packed leaves are recognised by their fields
(``planes``, ``bits``, ``qfn``, ``code_bits``, ``rot``, ...), never by
importing quip_tpu. Layer-stacked leaves (the (L, ...) ``blocks`` subtree,
including a packed leaf's (L,) ``scale_b`` and stacked ``rot`` arrays) are
split per layer. Rotations must be materialised in the tree (``rot``): the
port does not regenerate JAX keys (core/incoherence.py).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import MLP, Attention, Block, Model
from quip_tpu_torch.pack.format import PackedLinear

_PACKED_FIELDS = ("planes", "bits", "qfn", "code_bits", "rot", "proj_mode",
                  "out_features", "in_features", "scale_b")


def _is_packed(obj: Any) -> bool:
    return all(hasattr(obj, f) for f in _PACKED_FIELDS)


def _pick(t, layer: Optional[int]):
    """Layer ``layer`` of a stacked leaf (None: the leaf itself); keeps the
    ``()`` markers of absent rotation slots."""
    if t is None or (isinstance(t, tuple) and not t):
        return t
    return t if layer is None else t[layer]


def packed_from_numpy(obj, layer: Optional[int] = None,
                      device="cpu") -> PackedLinear:
    """One quip_tpu PackedLinear (numpy children) -> the port's module;
    ``layer`` picks one layer of a stacked leaf."""
    def tens(a, dtype=None):
        a = _pick(a, layer)
        if a is None or (isinstance(a, tuple) and not a):
            return a
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    if getattr(obj, "proj_key", None) is not None and obj.rot is None:
        raise ValueError("packed leaf carries a proj_key but no materialised "
                         "rot; the port cannot regenerate JAX keys")
    rot = None
    if obj.rot is not None:
        rot = {}
        for side, val in obj.rot.items():
            rot[side] = (tuple(tens(t, torch.float32) for t in val)
                         if isinstance(val, tuple) and side in ("u", "v")
                         else tens(val, torch.float32))
    scale = tens(obj.scale, torch.float32)
    zero = tens(obj.zero, torch.float32)
    return PackedLinear(
        tuple(tens(p, torch.int32) for p in obj.planes),
        scale.reshape(-1) if scale is not None else None,
        zero.reshape(-1) if zero is not None else None,
        tens(obj.scale_b, torch.float32), tens(obj.scaleWH, torch.float32),
        tens(obj.bias), bits=obj.bits, qfn=obj.qfn,
        proj_mode=obj.proj_mode, out_features=obj.out_features,
        in_features=obj.in_features, rot=rot, code_bits=obj.code_bits)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Model:
    """quip_tpu params (numpy leaves) -> a port ``Model`` on ``device``.
    Dense leaves are cast to ``dtype`` (None keeps theirs); packed planes,
    grid scales and rotations keep int32/f32."""
    dev = resolve_device(device)

    def leaf(a, layer=None):
        if a is None:
            return None
        if _is_packed(a):
            return packed_from_numpy(a, layer, dev)
        t = torch.from_numpy(np.array(_pick(a, layer)))
        return t.to(device=dev, dtype=dtype or t.dtype)

    blocks = tree["blocks"]
    L = cfg.n_layers
    mods = []
    for l in range(L):
        attn = {k: leaf(v, l) for k, v in blocks["attn"].items()}
        mlp = {k: leaf(v, l) for k, v in blocks["mlp"].items()}
        mods.append(Block(leaf(blocks["ln1"]["scale"], l),
                          leaf(blocks["ln2"]["scale"], l),
                          Attention(**attn), MLP(**mlp)))
    final = tree.get("final_ln")
    return Model(cfg, leaf(tree["embed"]["tokens"]), mods,
                 leaf(final["scale"]) if final is not None else None,
                 leaf(tree.get("lm_head")))
