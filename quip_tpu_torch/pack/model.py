"""Packed-model assembly and checkpoint IO.

Port of ``quip_tpu/pack/model.py``. The checkpoint is quip_tpu's, file for
file: ``arrays.npz`` holds the leaves of quip_tpu's param tree
(``leaf_{i}``, in its flatten order: dict keys sorted, a PackedLinear's
children in the order planes, scale, zero, scale_b, scaleWH, proj_key,
bias, rot), and ``tree.json`` its structure, the leaves' exotic dtypes,
the metadata and ``PACK_FORMAT_VERSION``. Blocks are stacked on a leading
layer axis, as quip_tpu stores them. Each package reads the other's
checkpoints.

Exotic dtypes: numpy has no bfloat16, so a bf16 leaf is stored as its
uint16 bits with the name recorded in tree.json (as quip_tpu does through
ml_dtypes); here torch's ``.view`` converts both ways. A PackedLinear's
``proj_key`` (a JAX PRNG key) is read and dropped: ``rot`` carries the
rotation (the RNG decision in core/incoherence.py). quip_tpu reads a
non-None ``proj_key`` as "this layer is rotated", so the port writes two
zero words there for every rotated layer; they are not a key, and
quip_tpu never regenerates from them while ``rot`` is present.

``transcode`` (the tools CLI's) writes a packed checkpoint dense as
quip_tpu's ``tools transcode`` does: the linears as float32 (in, out)
weights, every other leaf as stored.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.convert import packed_from_numpy
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.pack.format import (PACK_FORMAT_VERSION, PackedLinear,
                                        _rot_of, pack_layer_result)

# numpy's npz cannot hold these: stored as unsigned integer views, named
# in tree.json's leaf_dtypes (quip_tpu's _EXOTIC_VIEWS); the middle entry
# is the integer dtype of the same width that torch views them through
_EXOTIC = {
    "bfloat16": (np.uint16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2),
}
_BY_TORCH = {v[2]: (k, v[0], v[1]) for k, v in _EXOTIC.items()}
# the proj_key slot of a rotated layer (see the module docstring)
_KEY_MARKER = np.zeros(2, np.uint32)


class PackedLeaf(NamedTuple):
    """quip_tpu's PackedLinear node as the checkpoint holds it: its
    children (tensors; layer-stacked in ``blocks``) and its aux data.
    ``convert.packed_from_numpy`` turns one into the port's module."""

    planes: tuple
    scale: Any
    zero: Any
    scale_b: Any
    scaleWH: Any
    proj_key: Any
    bias: Any
    rot: Any
    bits: int
    qfn: str
    proj_mode: str
    out_features: int
    in_features: int
    code_bits: Optional[int]


_CHILDREN = ("planes", "scale", "zero", "scale_b", "scaleWH", "proj_key",
             "bias", "rot")
_AUX = ("bits", "qfn", "proj_mode", "out_features", "in_features",
        "code_bits")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def _replace_linears(params: M.Model, cfg: ModelConfig, new) -> M.Model:
    """A Model with each linear w replaced by ``new(full_name, w)``; norms
    and the embedding are shared."""
    specs = M.linear_specs(cfg, fused=params.blocks[0].attn.fused)
    blocks = [M.replace_linears(
        b, specs, lambda spec, w, li=li: new(f"layers.{li}.{spec.name}", w))
        for li, b in enumerate(params.blocks)]
    head = params.lm_head
    if head is not None:
        head = new("lm_head", head)
    return M.Model(cfg, params.embed, blocks, params.final_ln, head)


def pack_quantized_model(params: M.Model, cfg: ModelConfig, artifacts,
                         wbits: int) -> M.Model:
    """Swap each quantized linear for a PackedLinear built from its result
    in ``artifacts`` (a QuantizedModelArtifacts); linears without codes
    stay dense. The model routes every projection through
    ``ops.qlinear.linear_apply``, which dispatches on the leaf's type;
    the biases stay beside the packed weights (``bqkv``, ``bo``, ``b1``,
    ``b2``), where quip_tpu's tree keeps them."""
    def new(name, w):
        res = artifacts.results.get(name)
        if res is None or res.codes is None:
            return w
        return pack_layer_result(res, wbits)
    return _replace_linears(params, cfg, new)


def unpack_model(params: M.Model, dtype=torch.float32) -> M.Model:
    """Packed -> dense: every PackedLinear becomes its dequantized (in, out)
    weight in ``dtype`` (quip_tpu's unpack_model; reference opt.py:318-348).
    torch's matmul does not promote, so every other floating buffer of the
    model (embedding tables, norms, biases, a dense head) is cast to
    ``dtype`` too."""
    cast = lambda t: t.to(dtype)  # noqa: E731

    def new(_, w):
        if isinstance(w, PackedLinear):
            return w.dequantize(dtype).t()
        return cast(w)

    cfg = params.cfg
    out = _replace_linears(params, cfg, new)

    def with_cast_biases(mod, cls):      # bq/bk/bv/bqkv/bo/b1/b2
        kids = {k: getattr(mod, k) for k in cls.NAMES}
        return cls(**{k: cast(v) if k.startswith("b") else v
                      for k, v in kids.items() if v is not None})

    blocks = [M.Block(b.ln1.mapped(cast), b.ln2.mapped(cast),
                      with_cast_biases(b.attn, M.Attention),
                      with_cast_biases(b.mlp, M.MLP)) for b in out.blocks]
    final = None if out.final_ln is None else out.final_ln.mapped(cast)
    return M.Model(cfg, out.embed.mapped(cast), blocks, final, out.lm_head)


# ---------------------------------------------------------------------------
# Checkpoint IO
# ---------------------------------------------------------------------------


def _packed_leaf(q: PackedLinear) -> PackedLeaf:
    """The port's module as quip_tpu's node (one layer)."""
    col = lambda t: None if t is None else t[:, None]  # noqa: E731
    return PackedLeaf(
        q.planes, col(q.scale), col(q.zero), q.scale_b, q.scaleWH,
        _KEY_MARKER if q.has_rot else None, q.bias,
        _rot_of(q), q.bits, q.qfn, q.proj_mode, q.out_features, q.in_features,
        q.code_bits)


def _stack(xs):
    """Stack per-layer nodes on a leading axis (every layer must share one
    structure, as quip_tpu's stacked tree requires)."""
    x0 = xs[0]
    if isinstance(x0, PackedLeaf):
        aux = [tuple(getattr(x, f) for f in _AUX) for x in xs]
        if len(set(aux)) != 1:
            raise ValueError(f"layers differ in packed format: {set(aux)}")
        kids = {f: _stack([getattr(x, f) for x in xs]) for f in _CHILDREN}
        return x0._replace(**kids)
    if isinstance(x0, dict):
        return {k: _stack([x[k] for x in xs]) for k in x0}
    if isinstance(x0, tuple):
        return tuple(_stack([x[i] for x in xs]) for i in range(len(x0)))
    if x0 is None:
        return None
    if isinstance(x0, np.ndarray):
        return np.stack(xs)
    return torch.stack([x.detach().cpu() for x in xs])


def _node(w):
    return _packed_leaf(w) if isinstance(w, PackedLinear) else w


def _norm_tree(n: Optional[M.Norm]):
    if n is None:
        return None
    return {"scale": n.scale} if n.bias is None else {"scale": n.scale,
                                                       "bias": n.bias}


def _present(mod, keys) -> Dict[str, Any]:
    return {k: _node(getattr(mod, k)) for k in keys
            if getattr(mod, k) is not None}


def block_tree(b: M.Block) -> Dict[str, Any]:
    """One Block as quip_tpu's per-layer tree: ln1 / ln2 / attn / mlp,
    absent weights left out."""
    return {"ln1": _norm_tree(b.ln1), "ln2": _norm_tree(b.ln2),
            "attn": _present(b.attn, M.Attention.NAMES),
            "mlp": _present(b.mlp, M.MLP.NAMES)}


def model_tree(params: M.Model) -> Dict[str, Any]:
    """The port's Model as quip_tpu's param tree: embed / blocks (stacked)
    / final_ln / lm_head, packed linears as PackedLeaf nodes, absent parts
    left out as quip_tpu leaves them out."""
    layers = [block_tree(b) for b in params.blocks]
    embed = _present(params.embed, M.Embed.TABLES)
    if params.embed.ln is not None:
        embed["ln"] = _norm_tree(params.embed.ln)
    tree = {"embed": embed, "blocks": _stack(layers),
            "final_ln": _norm_tree(params.final_ln)}
    if params.lm_head is not None:
        tree["lm_head"] = _node(params.lm_head)
    return tree


def leaf_from_np(a: np.ndarray, name: Optional[str]):
    """A stored leaf back as a tensor: ``name`` the exotic dtype its
    integer view stands for (bf16, fp8), None for a plain array. A uint32
    leaf (a JAX key) stays numpy."""
    if name:
        if name not in _EXOTIC:
            raise ValueError(f"dtype {name} has no torch counterpart")
        _, t_view, t_dtype = _EXOTIC[name]
        return torch.from_numpy(a).view(t_view).view(t_dtype)
    if a.dtype == np.uint32:
        return a
    return torch.from_numpy(a)


def _leaf_to_np(t) -> Tuple[np.ndarray, Optional[str]]:
    if isinstance(t, np.ndarray):
        return t, None
    t = t.detach().cpu().contiguous()
    if t.dtype in _BY_TORCH:
        name, np_view, t_view = _BY_TORCH[t.dtype]
        return t.view(t_view).numpy().view(np_view), name
    return t.numpy(), None


def _to_json(tree, leaves: list):
    """quip_tpu's tree.json structure of ``tree``; leaves appended to
    ``leaves`` in its flatten order."""
    if isinstance(tree, PackedLeaf):
        return {"__t": "packed_linear",
                "aux": [getattr(tree, f) for f in _AUX],
                "children": [_to_json(getattr(tree, f), leaves)
                             for f in _CHILDREN]}
    if isinstance(tree, dict):
        return {"__t": "dict", "items": {k: _to_json(tree[k], leaves)
                                         for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__t": "list" if isinstance(tree, list) else "tuple",
                "items": [_to_json(v, leaves) for v in tree]}
    if tree is None:
        return {"__t": "none"}
    leaves.append(tree)
    return {"__t": "leaf"}


def save_checkpoint(path: str, params: M.Model,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a (possibly packed) Model as a quip_tpu checkpoint:
    ``path/arrays.npz`` + ``path/tree.json``."""
    save_tree(path, model_tree(params), meta)


def save_tree(path: str, tree: Dict[str, Any],
              meta: Optional[Dict[str, Any]] = None) -> None:
    """Write quip_tpu's param tree (dicts, tuples, ``PackedLeaf`` nodes;
    tensor or numpy leaves, as ``load_checkpoint`` reads them) as a
    checkpoint either package reads."""
    os.makedirs(path, exist_ok=True)
    leaves: list = []
    spec = {"treedef": _to_json(tree, leaves)}
    arrays, exotic = {}, {}
    for i, t in enumerate(leaves):
        a, name = _leaf_to_np(t)
        arrays[f"leaf_{i}"] = a
        if name:
            exotic[str(i)] = name
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    spec.update(meta=meta or {}, n_leaves=len(leaves), leaf_dtypes=exotic,
                pack_format_version=PACK_FORMAT_VERSION)
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(spec, f)


def _from_json(spec, leaves_iter):
    t = spec["__t"]
    if t == "dict":
        return {k: _from_json(v, leaves_iter)
                for k, v in spec["items"].items()}
    if t in ("list", "tuple"):
        items = [_from_json(v, leaves_iter) for v in spec["items"]]
        return items if t == "list" else tuple(items)
    if t == "packed_linear":
        kids = [_from_json(c, leaves_iter) for c in spec["children"]]
        aux = list(spec["aux"]) + [None] * (len(_AUX) - len(spec["aux"]))
        return PackedLeaf(*kids, *aux)
    if t == "none":
        return None
    return next(leaves_iter)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a checkpoint written by either package: (tree, meta). The tree
    holds CPU tensors (bf16 leaves restored from their uint16 views; a
    ``proj_key`` stays a numpy uint32 array) and PackedLeaf nodes,
    layer-stacked as stored; ``convert.params_from_numpy`` builds the Model
    from it."""
    with open(os.path.join(path, "tree.json")) as f:
        spec = json.load(f)
    ver = spec.get("pack_format_version", 1)
    if ver != PACK_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint at {path} uses packed-plane layout v{ver}; this "
            f"build reads v{PACK_FORMAT_VERSION} (halfword-spread "
            f"transposed). Re-quantize or transcode the checkpoint.")
    exotic = spec.get("leaf_dtypes", {})
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i in range(spec["n_leaves"]):
            leaves.append(leaf_from_np(data[f"leaf_{i}"],
                                       exotic.get(str(i))))
    return _from_json(spec["treedef"], iter(leaves)), spec["meta"]


# ---------------------------------------------------------------------------
# Transcoding (packed checkpoint -> dense checkpoint)
# ---------------------------------------------------------------------------


def unpack_tree(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """quip_tpu's ``unpack_model`` on a ``load_checkpoint`` tree: each
    ``PackedLeaf`` becomes its dequantized (in, out) float32 weight on the
    CPU, a layer-stacked one (L, in, out), dequantized a layer at a time on
    ``device``; every other leaf stays as stored (a bf16 embedding stays
    bf16). Unlike :func:`unpack_model` nothing is cast, so the tree is
    quip_tpu's leaf for leaf."""
    dev = resolve_device(device)

    def dense(leaf: PackedLeaf, layer: Optional[int]) -> torch.Tensor:
        q = packed_from_numpy(leaf, layer, dev)
        return q.dequantize(torch.float32).t().contiguous()

    def walk(node):
        if isinstance(node, PackedLeaf):
            if node.planes[0].ndim == 2:
                return dense(node, None).cpu()
            out = torch.empty((node.planes[0].shape[0], node.in_features,
                               node.out_features), dtype=torch.float32)
            for li in range(out.shape[0]):
                out[li].copy_(dense(node, li))
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def transcode(src: str, dst: str, device="cuda"
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The packed checkpoint at ``src`` written dense at ``dst`` (quip_tpu's
    ``tools transcode``; the reference's load_quant direction): the linears
    dequantized on ``device`` (:func:`unpack_tree`), the meta marked
    ``packed: False`` and ``transcoded_from: src``. Returns (tree, meta)."""
    tree, meta = load_checkpoint(src)
    dense = unpack_tree(tree, device)
    meta = dict(meta, packed=False, transcoded_from=src)
    save_tree(dst, dense, meta)
    return dense, meta
