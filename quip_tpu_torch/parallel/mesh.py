"""Process groups, meshes and sharding rules (port of
``quip_tpu/parallel/mesh.py``).

quip_tpu places every leaf with a ``NamedSharding`` and lets GSPMD insert
the collectives. Here each rank is one process that runs the same host
code on the same requests (SPMD), holds only its own shard of each leaf,
and calls the collectives itself (ops/qlinear.py, models/model.py,
models/paged.py, through parallel/comm.py). The rules are quip_tpu's, so
that a sharded result matches the unsharded one:

  * dense leaves follow ``_spec_for_dense``: column-parallel for
    ``_COL_PARALLEL`` (and their ``_COL_BIAS``), row-parallel for
    ``_ROW_PARALLEL`` (Megatron: one all-reduce after ``wo`` and after the
    down projection), the rest replicated. A fused dense ``wqkv`` / ``wgu``
    is split part by part (each rank's q, k and v columns, or gate and up
    columns, are its own heads' or its own half of d_ff), where quip_tpu's
    GSPMD shards the fused axis whole and reshards;
  * packed linears are always column-parallel (``_packed_linear_spec``):
    planes (nwords, m_p) -> (nwords, m_p / tp), a qfn-a ``scale`` /
    ``zero`` sliced the same way, the rest replicated; the forward gathers
    the output over tp before the U side. Because the bias is added after
    that gather, the port keeps a packed linear's own ``bias`` and the
    dense ``_COL_BIAS`` leaves beside packed linears whole (quip_tpu
    shards them and GSPMD gathers them each call);
  * an unstacked packed head (``--quant_head``) is replicated;
  * the paged cache shards its batch over dp and its kv heads over tp; a
    shared prefix its heads over tp. The per-slot cursors stay whole on
    every rank (the engine's host state is identical on every rank),
    where quip_tpu shards them over dp.

The spec helpers state, per leaf, which axis shards over which mesh axis
as a tuple (a ``PartitionSpec`` without trailing Nones), so tests hold
them against quip_tpu's leaf by leaf; ``shard_*`` return this rank's
local tensors by the same rules.

Transport (``init_distributed``): ranks that each have their own card use
NCCL; ranks that share a card, or run on the CPU, use gloo, whose CUDA
gaps parallel/comm.py stages through the host.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.ops.actquant import ActQuant
from quip_tpu_torch.ops.qlinear import TPLinear
from quip_tpu_torch.pack.format import PackedLinear, _rot_of
from quip_tpu_torch.parallel import comm
from quip_tpu_torch.parallel.comm import Axis

Spec = Tuple[Optional[str], ...]

_STATE: Dict[str, Any] = {"backend": "none", "device": None,
                          "timeout_s": 600.0}


def init_distributed(*, device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> Tuple[str, torch.device]:
    """Join (or start) the process group; returns (backend, this rank's
    device). Rank, world size and local rank default to ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` as ``torch.distributed.run`` sets them
    (``init_method`` then defaults to ``env://``, which reads
    ``MASTER_ADDR`` / ``MASTER_PORT``).

    The transport rule: ranks on the CPU use gloo; ranks on CUDA use NCCL
    when every local rank has a card of its own (``LOCAL_WORLD_SIZE`` <=
    the card count), else gloo, with local rank r on card r % count (NCCL
    refuses two ranks of one communicator on one card). Every group gets
    ``timeout_s``. A world of one starts no group."""
    import torch.distributed as dist
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = (int(env.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "quip_tpu_torch: device 'cuda' requested but no CUDA device "
                "is available; pass device='cpu' to run the plain path")
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n else "gloo"
    else:
        backend = "gloo"
    _STATE.update(backend=backend if world > 1 else "none", device=dev,
                  timeout_s=timeout_s)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return _STATE["backend"], dev


def shutdown_distributed() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend="none", device=None)


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of global ranks with named axes (``grid[i, j]`` is the rank
    at coordinates (i, j)). ``shape`` maps each axis to its size,
    ``coords`` to this rank's index along it; ``axis(name)`` is the
    parallel/comm.py ``Axis`` (with its process group) through this rank,
    a size-1 axis for a name the mesh lacks; ``world`` is the axis of
    every rank (the default group). ``device`` defaults to this rank's
    (``init_distributed``'s), else the card, raising without one. A mesh
    made with ``rank=`` and no process group is virtual: its rules shard,
    its collectives cannot run."""

    def __init__(self, grid: np.ndarray, names: Sequence[str],
                 rank: Optional[int] = None, device=None):
        import torch.distributed as dist
        self.grid = np.asarray(grid)
        self.axis_names = tuple(names)
        live = dist.is_initialized()
        me = dist.get_rank() if live and rank is None else (rank or 0)
        self.rank = me
        self.shape = dict(zip(self.axis_names, self.grid.shape))
        where = np.argwhere(self.grid == me)
        if not len(where):
            raise ValueError(f"rank {me} is not in the mesh {self.grid}")
        self.coords = dict(zip(self.axis_names, map(int, where[0])))
        self.device = resolve_device(device if device is not None else (
            _STATE["device"] or "cuda"))
        self.backend = _STATE["backend"] if live else "none"
        self.world = Axis("world", self.size, me, tuple(range(self.size)),
                          None, self.backend)
        timeout = datetime.timedelta(seconds=_STATE["timeout_s"])
        self._axes: Dict[str, Axis] = {}
        for d, name in enumerate(self.axis_names):
            size = self.grid.shape[d]
            mine = None
            lines = np.moveaxis(self.grid, d, -1).reshape(-1, size)
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = None
                if size > 1 and live:
                    # every rank creates every group, in the same order
                    group = dist.new_group(list(ranks), timeout=timeout)
                if me in ranks:
                    mine = Axis(name, size, ranks.index(me), ranks, group,
                                self.backend)
            self._axes[name] = mine

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def axis(self, name: str) -> Axis:
        return self._axes.get(name) or Axis(name, 1, 0, (self.rank,))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _check_world(n: int, what: str, rank: Optional[int]) -> int:
    me, world = _world()
    if rank is not None and world == 1:
        return n          # a virtual mesh: any size
    if n != world:
        raise ValueError(f"{what} = {n} ranks, but the process group has "
                         f"{world}")
    return world


def make_mesh(dp: int = 1, tp: Optional[int] = None, *,
              rank: Optional[int] = None, device=None) -> Mesh:
    """(dp, tp) mesh over the process group, tp contiguous (rank = i_dp ·
    tp + i_tp). Across hosts (``LOCAL_WORLD_SIZE`` below the world size)
    it delegates to :func:`make_hybrid_mesh`, so tp never crosses a host.
    ``rank`` without a process group makes a virtual mesh."""
    _, world = _world()
    if tp is None:
        tp = world // dp
    _check_world(dp * tp, f"dp*tp = {dp}*{tp}", rank)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if rank is None and local_world < world:
        return make_hybrid_mesh(dp, tp, device=device)
    return Mesh(np.arange(dp * tp).reshape(dp, tp), ("dp", "tp"), rank,
                device)


def hybrid_grid(dp: int, tp: Optional[int], world: int,
                per_host: int) -> np.ndarray:
    """quip_tpu's hybrid (dp, tp) layout and checks as a grid of global
    ranks (host-major numbering, as torch.distributed.run gives): tp must
    divide the ranks of a host (no tensor parallelism across hosts); dp
    must be hosts x the host's leftover ranks, hosts outermost on dp."""
    n_hosts = world // per_host
    if tp is None:
        tp = per_host
    if per_host % tp:
        raise ValueError(f"tp={tp} must divide per-host device count "
                         f"{per_host} (no cross-host tensor parallelism)")
    ici_dp = per_host // tp
    if dp != n_hosts * ici_dp:
        raise ValueError(f"dp={dp} != hosts({n_hosts}) x "
                         f"leftover-per-host({ici_dp})")
    return np.arange(world).reshape(n_hosts * ici_dp, tp)


def make_hybrid_mesh(dp: int, tp: Optional[int] = None, *,
                     device=None) -> Mesh:
    """(dp, tp) mesh across hosts: hosts outermost on dp, tp within a host
    (``hybrid_grid``'s checks raise as quip_tpu's asserts)."""
    _, world = _world()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world // per_host == 1:
        return make_mesh(dp, tp, device=device)
    return Mesh(hybrid_grid(dp, tp, world, per_host), ("dp", "tp"),
                device=device)


def make_pp_mesh(pp: int, *, rank: Optional[int] = None,
                 device=None) -> Mesh:
    """1-D 'pp' mesh: each rank holds a contiguous slice of the blocks."""
    _check_world(pp, f"pp = {pp}", rank)
    return Mesh(np.arange(pp), ("pp",), rank, device)


def make_mesh_pp_tp(pp: int, tp: int, *, rank: Optional[int] = None,
                    device=None) -> Mesh:
    """2-D (pp, tp) mesh: layers split over pp stages, each stage's
    linears tp-sharded within it."""
    _check_world(pp * tp, f"pp*tp = {pp}*{tp}", rank)
    return Mesh(np.arange(pp * tp).reshape(pp, tp), ("pp", "tp"), rank,
                device)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

# quip_tpu's sets: column-parallel (out features) and row-parallel (in
# features) linears, and the biases of column-parallel outputs
_COL_PARALLEL = {"wq", "wk", "wv", "w1", "wg", "wu", "wqkv", "wgu"}
_ROW_PARALLEL = {"wo", "w2", "wd"}
_COL_BIAS = {"bq", "bk", "bv", "b1", "bqkv"}
_REPLICATED: Spec = ()


def _trim(spec) -> Spec:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _spec_for_dense(name: str, ndim: int) -> Spec:
    """quip_tpu's rule on a per-layer dense leaf (weights (in, out),
    biases (feat,))."""
    if name in _COL_PARALLEL and ndim == 2:
        return (None, "tp")
    if name in _ROW_PARALLEL and ndim == 2:
        return ("tp",)
    if name in _COL_BIAS and ndim == 1:
        return ("tp",)
    return _REPLICATED


def _packed_block(grp: torch.nn.Module) -> bool:
    names = M.Attention.NAMES if isinstance(grp, M.Attention) else M.MLP.NAMES
    return any(isinstance(_bare(getattr(grp, n)), PackedLinear)
               for n in names)


def _bare(w):
    return w.inner if isinstance(w, ActQuant) else w


def _packed_specs(q: PackedLinear, in_block: bool) -> Dict[str, Spec]:
    """Specs of a packed linear's leaves (plane index, 'scale', 'zero',
    'scale_b', 'scaleWH', 'bias', 'rot'): column-parallel inside a block,
    all replicated for the unstacked head."""
    cols = (None, "tp") if in_block else _REPLICATED
    rows = ("tp",) if in_block else _REPLICATED
    out = {f"planes.{i}": cols for i in range(q.nplanes)}
    for name, t in (("scale", q.scale), ("zero", q.zero)):
        if t is not None:
            out[name] = rows
    for name in ("scale_b", "scaleWH", "bias"):
        if getattr(q, name) is not None:
            out[name] = _REPLICATED
    if q.has_rot:
        out["rot"] = _REPLICATED
    return out


def _block_specs(b: M.Block) -> Dict[str, Spec]:
    out: Dict[str, Spec] = {}
    for nm in ("ln1", "ln2"):
        n = getattr(b, nm)
        out[f"{nm}.scale"] = _REPLICATED
        if n.bias is not None:
            out[f"{nm}.bias"] = _REPLICATED
    for grp_name in ("attn", "mlp"):
        grp = getattr(b, grp_name)
        names = (M.Attention.NAMES if grp_name == "attn" else M.MLP.NAMES)
        packed = _packed_block(grp)
        for n in names:
            w = _bare(getattr(grp, n))
            if w is None:
                continue
            if isinstance(w, PackedLinear):
                for k, s in _packed_specs(w, True).items():
                    out[f"{grp_name}.{n}.{k}"] = s
            elif packed and n in _COL_BIAS:
                out[f"{grp_name}.{n}"] = _REPLICATED
            else:
                out[f"{grp_name}.{n}"] = _spec_for_dense(n, w.dim())
    return out


def _misc_specs(params: M.Model) -> Dict[str, Spec]:
    out = {f"embed.{k}": _REPLICATED for k in M.Embed.TABLES
           if getattr(params.embed, k) is not None}
    if params.embed.ln is not None:
        out["embed.ln.scale"] = _REPLICATED
        if params.embed.ln.bias is not None:
            out["embed.ln.bias"] = _REPLICATED
    if params.final_ln is not None:
        out["final_ln.scale"] = _REPLICATED
        if params.final_ln.bias is not None:
            out["final_ln.bias"] = _REPLICATED
    head = _bare(params.lm_head)
    if isinstance(head, PackedLinear):
        out.update({f"lm_head.{k}": s
                    for k, s in _packed_specs(head, False).items()})
    elif head is not None:
        out["lm_head"] = _REPLICATED
    return out


def split_specs(params: M.Model, cfg: ModelConfig) -> Dict[str, Spec]:
    """Per-leaf specs of the per-layer (split) form, the port's only form:
    ``blocks.<i>.<leaf>`` without a layer axis (quip_tpu's
    ``split_specs``), and the embedding, final norm and head replicated."""
    out = _misc_specs(params)
    for i, b in enumerate(params.blocks):
        out.update({f"blocks.{i}.{k}": s
                    for k, s in _block_specs(b).items()})
    return out


def param_specs(params: M.Model, cfg: ModelConfig,
                layer_axis: Optional[str] = None) -> Dict[str, Spec]:
    """quip_tpu's ``param_specs`` (the stacked form): each block leaf's
    spec with the layer axis first, named ``layer_axis`` (e.g. 'pp': a
    stage holds a contiguous slice of the blocks) or None, keyed
    ``blocks.<leaf>`` (one entry for all layers)."""
    out = _misc_specs(params)
    for k, s in _block_specs(params.blocks[0]).items():
        out[f"blocks.{k}"] = _trim((layer_axis,) + tuple(s)) if (
            s or layer_axis) else _REPLICATED
    return out


def cache_specs(cfg: ModelConfig) -> Spec:
    """The contiguous cache (layers, batch, len, kv_heads, hd): batch over
    dp, heads over tp."""
    return (None, "dp", None, "tp")


def paged_cache_specs(caches) -> Dict[str, Spec]:
    """Specs of a PagedKV's fields: frozen and hot k/v and the int8
    scales shard batch over dp and heads over tp; the cursors ``base`` /
    ``hot_len`` stay whole (see the module docstring)."""
    out = {}
    for f in ("k", "v", "hot_k", "hot_v", "ks", "vs", "hot_ks", "hot_vs"):
        if getattr(caches, f) is not None:
            out[f] = (None, "dp", None, "tp")
    out["base"] = out["hot_len"] = _REPLICATED
    return out


def data_spec() -> Spec:
    """Batch-sharded activations / tokens."""
    return ("dp",)


def seq_sharded_spec() -> Spec:
    """Sequence-axis sharding of tokens (B, S) over dp (quip_tpu's
    long-context prefill spec)."""
    return (None, "dp")


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------


def _part(t: torch.Tensor, dim: int, axis: Axis, what: str) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim``."""
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"{what}: {n} along dim {dim} of shape "
                         f"{tuple(t.shape)} is not divisible by "
                         f"{axis.name}={axis.size}")
    k = n // axis.size
    return t.narrow(dim, axis.index * k, k).contiguous()


def _parts(t: torch.Tensor, sizes: Sequence[int], axis: Axis,
           what: str) -> torch.Tensor:
    """A fused last axis [p0 | p1 | ...] of part ``sizes``: this rank's
    slice of every part, concatenated."""
    chunks = torch.split(t, list(sizes), dim=-1)
    return torch.cat([_part(c, -1, axis, what) for c in chunks], dim=-1)


def shard_packed(q: PackedLinear, axis: Axis, what: str) -> PackedLinear:
    """A column shard of a packed linear: planes (nwords, m_p / tp), a
    qfn-a scale / zero likewise; ``out_features`` stays the whole layer's
    (the forward gathers before slicing to it); everything else shared."""
    m_p = q.planes[0].shape[-1]
    if m_p % axis.size:
        raise ValueError(
            f"{what}: packed planes {tuple(q.planes[0].shape)} have m_p = "
            f"{m_p} columns, not divisible by tp = {axis.size}")
    planes = tuple(_part(p, -1, axis, what) for p in q.planes)
    cut = lambda t: None if t is None else _part(t, 0, axis, what)  # noqa
    return PackedLinear(planes, cut(q.scale), cut(q.zero), q.scale_b,
                        q.scaleWH, q.bias, bits=q.bits, qfn=q.qfn,
                        proj_mode=q.proj_mode, out_features=q.out_features,
                        in_features=q.in_features, rot=_rot_of(q),
                        code_bits=q.code_bits)


def _fused_sizes(name: str, cfg: ModelConfig) -> Optional[List[int]]:
    if name in ("wqkv", "bqkv"):
        return [cfg.n_heads * cfg.hd] + [cfg.kv_heads * cfg.hd] * 2
    if name == "wgu":
        return [cfg.d_ff] * 2
    return None


def _shard_linear(name: str, w, cfg: ModelConfig, axis: Axis, what: str):
    """A block linear as a TPLinear: packed -> column shard, gathered;
    dense -> column ('col', fused ones part by part) or row ('row')."""
    act = w if isinstance(w, ActQuant) else None
    inner = _bare(w)
    if isinstance(inner, PackedLinear):
        inner, layout = shard_packed(inner, axis, what), "gather"
    elif name in _COL_PARALLEL:
        sizes = _fused_sizes(name, cfg)
        inner = (_parts(inner, sizes, axis, what) if sizes
                 else _part(inner, -1, axis, what))
        layout = "col"
    else:
        if act is not None:
            raise NotImplementedError(
                f"{what}: an activation-quantized dense row-parallel linear "
                f"would quantize on a shard of its input")
        inner, layout = _part(inner, 0, axis, what), "row"
    if act is not None:
        inner = ActQuant(inner, act.scale, act.zero, act.maxq)
    return TPLinear(inner, layout, axis)


def shard_block(b: M.Block, cfg: ModelConfig, tp: Axis,
                where: str = "block") -> M.Block:
    """One block's tp shard: every linear a TPLinear, the column biases of
    dense linears sliced (fused ones part by part), the norms shared; the
    attention and MLP carry the axis (``tp``) for their collectives."""
    if cfg.n_heads % tp.size or cfg.kv_heads % tp.size:
        raise ValueError(f"n_heads={cfg.n_heads} and kv_heads="
                         f"{cfg.kv_heads} must be divisible by tp="
                         f"{tp.size}")
    groups = {}
    for grp_name, cls in (("attn", M.Attention), ("mlp", M.MLP)):
        grp = getattr(b, grp_name)
        packed = _packed_block(grp)
        parts = {}
        for n in cls.NAMES:
            w = getattr(grp, n)
            if w is None:
                continue
            what = f"{where}.{grp_name}.{n}"
            if n in _COL_PARALLEL or n in _ROW_PARALLEL:
                w = _shard_linear(n, w, cfg, tp, what)
            elif n in _COL_BIAS and not packed:
                sizes = _fused_sizes(n, cfg)
                w = (_parts(w, sizes, tp, what) if sizes
                     else _part(w, -1, tp, what))
            parts[n] = w
        mod = cls(**parts)
        mod.tp = tp
        groups[grp_name] = mod
    return M.Block(b.ln1, b.ln2, groups["attn"], groups["mlp"])


def shard_params(params: M.Model, cfg: ModelConfig, mesh: Mesh,
                 memo: Optional[dict] = None) -> M.Model:
    """This rank's Model on a (dp, tp) mesh: blocks tp-sharded
    (``shard_block``), the embedding, final norm and head replicated (the
    same modules); the Model carries the mesh's ``tp`` and ``dp`` axes.
    ``memo`` (id of a block -> its shard), shared between a target and its
    self-draft, shards their common blocks once. At tp = 1 the blocks are
    the given ones."""
    tp, dp = mesh.axis("tp"), mesh.axis("dp")
    memo = {} if memo is None else memo

    def one(i, b):
        if tp.size == 1:
            return b
        if id(b) not in memo:
            memo[id(b)] = (b, shard_block(b, cfg, tp, f"blocks.{i}"))
        return memo[id(b)][1]

    out = M.Model(cfg, params.embed, [one(i, b) for i, b in
                                      enumerate(params.blocks)],
                  params.final_ln, params.lm_head)
    out.tp, out.dp = tp, dp
    return out


def shard_split(params: M.Model, cfg: ModelConfig, mesh: Mesh,
                memo: Optional[dict] = None) -> M.Model:
    """The port has only the per-layer form: ``shard_params``."""
    return shard_params(params, cfg, mesh, memo)


def _slots(batch: int, dp: Axis) -> Tuple[int, int]:
    if batch % dp.size:
        raise ValueError(f"batch {batch} is not divisible by dp={dp.size}")
    n = batch // dp.size
    return dp.index * n, (dp.index + 1) * n


def shard_paged(caches, mesh: Mesh):
    """This rank's PagedKV: slots [dp shard] and kv heads [tp shard] of
    every level and scale; the cursors whole, and ``slots`` naming the
    global slots the tensors hold (None at dp = 1)."""
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    B = caches.k.shape[1]
    lo, hi = _slots(B, dp)

    def cut(t):
        if t is None:
            return None
        return _part(t[:, lo:hi], 3, tp, "kv heads").contiguous()

    fields = {f: cut(getattr(caches, f)) for f in
              ("k", "v", "hot_k", "hot_v", "ks", "vs", "hot_ks", "hot_vs")}
    return caches._replace(**fields,
                           slots=(lo, hi) if dp.size > 1 else None)


def shard_prefix(prefix, mesh: Mesh):
    """A shared prefix's kv heads over tp, whole over dp."""
    tp = mesh.axis("tp")
    cut = lambda t: None if t is None else _part(t, 2, tp,  # noqa: E731
                                                 "prefix kv heads")
    return prefix._replace(k=cut(prefix.k), v=cut(prefix.v),
                           ks=cut(prefix.ks), vs=cut(prefix.vs))


def shard_params_pp(params: M.Model, cfg: ModelConfig,
                    mesh: Mesh) -> M.Model:
    """This stage's Model on a 'pp' mesh: its contiguous n_layers / pp
    blocks, the embedding, final norm and head replicated."""
    pp = mesh.axis("pp")
    if cfg.n_layers % pp.size:
        raise ValueError(f"n_layers={cfg.n_layers} is not divisible by "
                         f"pp={pp.size}")
    per = cfg.n_layers // pp.size
    blocks = list(params.blocks)[pp.index * per:(pp.index + 1) * per]
    return M.Model(cfg, params.embed, blocks, params.final_ln,
                   params.lm_head)


def shard_params_pp_tp(params: M.Model, cfg: ModelConfig,
                       mesh: Mesh) -> M.Model:
    """This rank's Model on a (pp, tp) mesh: its stage's blocks
    (``shard_params_pp``), each tp-sharded (``shard_block``)."""
    stage = shard_params_pp(params, cfg, mesh)
    tp = mesh.axis("tp")
    if tp.size > 1:
        stage = M.Model(cfg, stage.embed,
                        [shard_block(b, cfg, tp) for b in stage.blocks],
                        stage.final_ln, stage.lm_head)
    stage.tp = tp
    return stage


def checksum(params: M.Model) -> float:
    """A float64 sum over every tensor of the model (int planes as their
    values), for holding replicas equal with one all-reduce."""
    total = 0.0
    for t in list(params.buffers()) + list(params.parameters()):
        total += float(t.detach().to(torch.float64).sum())
    return total


def check_replicas(params: M.Model, mesh: Mesh) -> float:
    """Raise unless every rank holds the same weights: the largest and
    the smallest ``checksum`` over the ranks (one all-reduce) must be this
    rank's. Returns the checksum."""
    c = checksum(params)
    if mesh.backend != "none":
        dev = mesh.device if mesh.backend == "nccl" else "cpu"
        t = comm.all_reduce(torch.tensor([c, -c], dtype=torch.float64,
                                         device=dev), mesh.world, op="max")
        if float(t[0]) != c or float(-t[1]) != c:
            raise RuntimeError(f"ranks hold different weights: checksums "
                               f"from {float(-t[1])} to {float(t[0])}")
    return c


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def _share_cores(device, world: int) -> int:
    """On the CPU, give each of ``world`` ranks its share of the cores
    (ranks that each take them all thrash); returns the thread count the
    caller had."""
    had = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, min(had, (os.cpu_count() or 1)
                                         // world)))
    return had


def _child(fn, rank, world, init_method, device, timeout_s, quiet, args,
           results):
    import sys
    if quiet and rank:
        sys.stdout = sys.stderr = open(os.devnull, "w")
    try:
        _share_cores(device, world)
        init_distributed(device=device, init_method=init_method, rank=rank,
                         world_size=world, timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:             # reported to the parent, then exit
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown_distributed()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              device="cpu", timeout_s: float = 600.0,
              collective_timeout_s: float = 60.0,
              rank0_here: bool = False, quiet: bool = False) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, one process each, in a gloo
    or NCCL group (``init_distributed``'s rule) met through a fresh
    ``file://`` rendezvous, so concurrent runs never race for a port.
    Children start by the spawn method (``fn`` must be importable). With
    ``rank0_here`` this process is rank 0 and its group is torn down
    after; else every rank is a child. ``quiet`` silences the children's
    standard output (rank 0 alone prints). Returns the ranks' return
    values in rank order (None for rank 0 when it ran here and raised).
    Every child is joined by ``timeout_s``; a child's exception raises
    here with its traceback, and the others are terminated."""
    import multiprocessing as mp
    import queue as _queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="quip_rdzv_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    first = 1 if rank0_here else 0
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, init, device,
                               collective_timeout_s, quiet, args, results),
                         daemon=True)
             for r in range(first, world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    errors: List[str] = []
    here_err = None
    try:
        if rank0_here:
            threads = _share_cores(device, world)
            try:
                init_distributed(device=device, init_method=init, rank=0,
                                 world_size=world,
                                 timeout_s=collective_timeout_s)
                out[0] = fn(*args)
            except BaseException as e:   # children's tracebacks first
                here_err = e
            finally:
                shutdown_distributed()
                torch.set_num_threads(threads)
        deadline = time.time() + timeout_s
        pending = len(procs)
        while pending:
            left = deadline - time.time()
            if left <= 0:
                errors.append(f"ranks did not finish within {timeout_s} s")
                break
            try:
                rank, kind, val = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and \
                        results.empty():
                    dead = [p.exitcode for p in procs]
                    errors.append(f"a rank died without a report "
                                  f"(exit codes {dead})")
                    break
                continue
            pending -= 1
            if kind == "error":
                errors.append(f"rank {rank}:\n{val}")
                break
            out[rank] = val
    finally:
        for p in procs:
            if errors or here_err is not None:
                p.terminate()
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors)) from here_err
    if here_err is not None:
        raise here_err
    return out


def init_paged_shard(batch: int, capacity: int, cfg: ModelConfig,
                     mesh: Mesh, **kw):
    """This rank's shard of ``paged.init_paged(batch, capacity, cfg,
    **kw)`` made directly (no whole cache first): its dp shard of the
    slots and tp shard of the kv heads, the cursors whole."""
    import dataclasses
    from quip_tpu_torch.models import paged as PG
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    lo, hi = _slots(batch, dp)
    if cfg.kv_heads % tp.size:
        raise ValueError(f"kv_heads={cfg.kv_heads} is not divisible by "
                         f"tp={tp.size}")
    local = PG.init_paged(hi - lo, capacity, dataclasses.replace(
        cfg, n_kv_heads=cfg.kv_heads // tp.size), **kw)
    z = torch.zeros(batch, dtype=torch.int32)
    return local._replace(base=z, hot_len=z.clone(),
                          slots=(lo, hi) if dp.size > 1 else None)


def init_arena_shard(batch: int, max_seq: int, cfg: ModelConfig,
                     mesh: Mesh, dtype=torch.float32, **kw):
    """This rank's shard of ``serve/arena.py::init_arena(cfg, batch,
    max_seq, dtype, **kw)``: its dp shard of the slots (named in
    ``slots``) and tp shard of the kv heads."""
    import dataclasses
    from quip_tpu_torch.serve import arena as AR
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    lo, hi = _slots(batch, dp)
    if cfg.kv_heads % tp.size:
        raise ValueError(f"kv_heads={cfg.kv_heads} is not divisible by "
                         f"tp={tp.size}")
    local = AR.init_arena(dataclasses.replace(
        cfg, n_kv_heads=cfg.kv_heads // tp.size), hi - lo, max_seq, dtype,
        **kw)
    return local._replace(slots=(lo, hi) if dp.size > 1 else None)
