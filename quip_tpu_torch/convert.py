"""Turn a quip_tpu param tree (as numpy) into the port's modules.

Input is the tree as ``jax.tree.map(np.asarray, params)`` leaves it:
nested dicts of numpy arrays, with quip_tpu ``PackedLinear`` nodes whose
children became numpy; or as ``pack.model.load_checkpoint`` reads it from
disk (CPU tensors, ``PackedLeaf`` nodes). Packed leaves are recognised by
their fields (``planes``, ``bits``, ``qfn``, ``code_bits``, ``rot``, ...),
never by importing quip_tpu. Layer-stacked leaves (the (L, ...)
``blocks`` subtree, including a packed leaf's (L,) ``scale_b`` and stacked
``rot`` arrays) are split per layer. Rotations must be materialised in the
tree (``rot``): the port does not regenerate JAX keys
(core/incoherence.py). An RHT ``rot`` is cast to float32; a butterfly
``rot`` nests a tuple of blocks (float32) and two int32 permutations (or
None), each kept in its kind.

quip_tpu's cache containers (``KVCache``, ``PagedKV`` with or without int8
scales, ``Prefix``), likewise as numpy, become the port's by their field
names; cursors (``length``, ``base``, ``hot_len``) stay on the host.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.models.model import (MLP, Attention, Block, Embed,
                                         KVCache, Model, Norm)
from quip_tpu_torch.models.paged import PagedKV, Prefix
from quip_tpu_torch.pack.format import PackedLinear

_PACKED_FIELDS = ("planes", "bits", "qfn", "code_bits", "rot", "proj_mode",
                  "out_features", "in_features", "scale_b")


def _is_packed(obj: Any) -> bool:
    return all(hasattr(obj, f) for f in _PACKED_FIELDS)


def _tensor(a) -> torch.Tensor:
    """A numpy array or a tensor as a tensor (bf16 tensors have no numpy
    form)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _pick(t, layer: Optional[int]):
    """Layer ``layer`` of a stacked leaf (None: the leaf itself); keeps the
    ``()`` markers of absent rotation slots."""
    if t is None or (isinstance(t, tuple) and not t):
        return t
    return t if layer is None else t[layer]


def packed_from_numpy(obj, layer: Optional[int] = None,
                      device="cuda") -> PackedLinear:
    """One quip_tpu PackedLinear (numpy children) -> the port's module on
    ``device``; ``layer`` picks one layer of a stacked leaf."""
    device = resolve_device(device)
    def tens(a, dtype=None):
        a = _pick(a, layer)
        if a is None or (isinstance(a, tuple) and not a):
            return a
        t = _tensor(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    if getattr(obj, "proj_key", None) is not None and obj.rot is None:
        raise ValueError("packed leaf carries a proj_key but no materialised "
                         "rot; the port cannot regenerate JAX keys")
    rot = None
    if obj.rot is not None and inc.is_butterfly(obj.proj_mode):
        # each side (blocks, perm_in, perm_out): f32 blocks, int32 perms
        rot = {side: (tuple(tens(b, torch.float32) for b in blocks),
                      tens(pin, torch.int32), tens(pout, torch.int32))
               for side, (blocks, pin, pout) in obj.rot.items()}
    elif obj.rot is not None:
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
                      dtype: Optional[torch.dtype] = None,
                      mesh=None) -> Model:
    """quip_tpu params (numpy leaves) -> a port ``Model`` on ``device``,
    for every family: norms are ``{"scale"[, "bias"]}`` dicts,
    ``final_ln`` None for post-norm OPT, ``embed`` holds ``tokens`` and
    whichever of ``positions``, ``proj_in``, ``proj_out`` and ``ln`` the
    family has. Dense leaves are cast to ``dtype`` (None keeps theirs);
    packed planes, grid scales and rotations keep int32/f32. ``mesh`` (a
    parallel/mesh.py mesh) returns this rank's shard
    (``parallel/mesh.py::shard_params``)."""
    dev = resolve_device(device)

    def leaf(a, layer=None):
        if a is None:
            return None
        if _is_packed(a):
            return packed_from_numpy(a, layer, dev)
        t = _tensor(_pick(a, layer))
        return t.to(device=dev, dtype=dtype or t.dtype)

    def norm(d, layer=None):
        if d is None:
            return None
        return Norm(leaf(d["scale"], layer), leaf(d.get("bias"), layer))

    blocks = tree["blocks"]
    mods = []
    for l in range(cfg.n_layers):
        attn = {k: leaf(v, l) for k, v in blocks["attn"].items()}
        mlp = {k: leaf(v, l) for k, v in blocks["mlp"].items()}
        mods.append(Block(norm(blocks["ln1"], l), norm(blocks["ln2"], l),
                          Attention(**attn), MLP(**mlp)))
    e = tree["embed"]
    emb = Embed(*(leaf(e.get(k)) for k in Embed.TABLES), ln=norm(e.get("ln")))
    model = Model(cfg, emb, mods, norm(tree.get("final_ln")),
                  leaf(tree.get("lm_head")))
    if mesh is None:
        return model
    from quip_tpu_torch.parallel.mesh import shard_params
    return shard_params(model, cfg, mesh)


def _cache_fields(obj, cls, device, host=(), skip=()):
    """The fields of ``cls`` but ``skip`` read off ``obj`` as tensors on
    ``device`` (``host`` fields as int32 tensors on the CPU; None stays
    None)."""
    device = resolve_device(device)
    out = {}
    for f in (f for f in cls._fields if f not in skip):
        a = getattr(obj, f)
        if a is None:
            out[f] = None
        elif f in host:
            out[f] = torch.from_numpy(np.array(a, np.int32))
        else:
            out[f] = torch.from_numpy(np.array(a)).to(device)
    return out


def kvcache_from_numpy(obj, device="cuda") -> KVCache:
    """quip_tpu ``KVCache`` (stacked or per layer; numpy leaves)."""
    return KVCache(**_cache_fields(obj, KVCache, device, host=("length",)))


def paged_from_numpy(obj, device="cuda") -> PagedKV:
    """quip_tpu ``PagedKV`` (numpy leaves), int8 scales included: every
    slot's tensors (the port's ``slots`` field stays None)."""
    return PagedKV(**_cache_fields(obj, PagedKV, device,
                                   host=("base", "hot_len"),
                                   skip=("slots",)))


def prefix_from_numpy(obj, device="cuda") -> Prefix:
    """quip_tpu ``Prefix`` (numpy leaves)."""
    f = _cache_fields(obj, Prefix, device, host=("length",))
    return Prefix(**{**f, "length": int(f["length"])})
