"""Collectives of the sharded port, and their accounting (port of
``quip_tpu/parallel/comm.py``).

quip_tpu lets GSPMD insert its collectives and reads them back out of the
optimised HLO (``collectives_from_hlo``). PyTorch has no partitioner and
no HLO, so that function has no counterpart here: the port writes every
collective out, and each goes through one of this module's wrappers
(``all_gather``, ``all_reduce``, ``broadcast``, ``send`` / ``recv``, and
``broadcast_object`` for the requests the serving leader shares).
Each call adds plain integers to a per-kind counter: calls, result bytes,
ring-model wire bytes (``_wire_bytes``, quip_tpu's cost model, copied) and
the bytes staged through the host (below). ``comm_report(fn, args)``
resets the counters, runs ``fn`` once and returns quip_tpu's keys.

Transport. Ranks that each have their own card talk over NCCL; ranks that
share a card, or run on the CPU, over gloo (``parallel/mesh.py::
init_distributed`` makes the choice). gloo's backend table takes CUDA
tensors for ``broadcast`` and ``all_reduce`` only, so on a gloo group an
all-gather or a send / recv of a CUDA tensor is copied through pinned host
memory, explicitly and by that table (``_STAGED``); the copies' bytes (to
the host and back) are counted as ``host_staged``. Nothing here catches a
failed collective: it raises, and every group has a timeout.

A collective over an axis of size 1 is the identity and counts nothing
(GSPMD emits none there either).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# kinds named as quip_tpu's HLO reader names them; a send / recv pair is
# one 'collective-permute' hop there, charged here to the sender.
# 'broadcast-object' (pickled host objects) has no HLO counterpart.
KINDS = ("all-gather", "all-reduce", "broadcast", "send", "recv",
         "broadcast-object")
_FIELDS = ("count", "bytes", "wire_bytes", "host_staged")

# (backend, kind) pairs that take CUDA tensors; gloo's table names only
# broadcast and all_reduce (torch.distributed's backend table)
_CUDA_NATIVE = {("nccl", k) for k in KINDS} | {("gloo", "all-reduce"),
                                               ("gloo", "broadcast")}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its ``size``, this rank's
    ``index`` along it, the global ``ranks`` along it (in index order) and
    the process ``group`` over them (None when size is 1, and for a
    mesh's ``world`` axis, where None is the default group)."""

    name: str
    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)
    group: Any = None
    backend: str = "none"

    def global_rank(self, index: int) -> int:
        return self.ranks[index]


def _zero() -> Dict[str, Dict[str, float]]:
    return {k: {f: 0 for f in _FIELDS} for k in KINDS}


_COUNTS = _zero()
_RECORD: Optional[List[Dict[str, Any]]] = None


def reset() -> None:
    """Zero every counter."""
    global _COUNTS
    _COUNTS = _zero()


def counts() -> Dict[str, Dict[str, float]]:
    """A copy of the per-kind counters (kinds never called read 0)."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def snapshot() -> List[float]:
    """The counters as one flat list (serve/graphs.py: a captured graph
    adds its capture's collectives again at every replay)."""
    return [_COUNTS[k][f] for k in KINDS for f in _FIELDS]


def add(delta: Sequence[float]) -> None:
    """Add a ``snapshot`` difference to the counters."""
    it = iter(delta)
    for k in KINDS:
        for f in _FIELDS:
            _COUNTS[k][f] += next(it)


def _wire_bytes(kind: str, result_bytes: int, group: int) -> float:
    """Ring-model per-device wire traffic for one collective (quip_tpu's
    model, copied)."""
    if group <= 1:
        return 0.0
    g = group
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)          # input is g x result
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)


def _count(kind: str, t, axis: Axis, staged: int,
           wire_kind: Optional[str] = None, nbytes: int = 0) -> None:
    """Count one call of ``kind`` whose result is ``t`` (a tensor, or None
    with its ``nbytes`` for a host object)."""
    if t is not None:
        nbytes = t.numel() * t.element_size()
    wire = (0.0 if wire_kind == "" else
            _wire_bytes(wire_kind or kind, nbytes, axis.size))
    c = _COUNTS[kind]
    c["count"] += 1
    c["bytes"] += nbytes
    c["wire_bytes"] += wire
    c["host_staged"] += staged
    if _RECORD is not None:
        _RECORD.append({"kind": kind, "dtype": "object" if t is None
                        else str(t.dtype).split(".")[-1],
                        "shape": "" if t is None
                        else ",".join(map(str, t.shape)),
                        "bytes": nbytes, "group": axis.size,
                        "axis": axis.name, "host_staged": staged})


def _staged(kind: str, axis: Axis, t: torch.Tensor) -> bool:
    """Whether this call copies ``t`` through the host: a CUDA tensor on a
    backend whose table lacks the kind."""
    return t.is_cuda and (axis.backend, kind) not in _CUDA_NATIVE


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order."""
    if axis.size == 1:
        return x
    import torch.distributed as dist
    x = x.contiguous()
    staged = _staged("all-gather", axis, x)
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    nbytes = 0
    if staged:
        out = out.to(x.device)
        nbytes = (x.numel() + out.numel()) * x.element_size()
    _count("all-gather", out, axis, nbytes)
    return out


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the largest) over every rank's ``x``, a new
    tensor; ``x`` is untouched."""
    if axis.size == 1:
        return x
    import torch.distributed as dist
    out = x.clone().contiguous()
    staged = _staged("all-reduce", axis, out)
    buf = _to_host(out) if staged else out
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op],
                    group=axis.group)
    nbytes = 0
    if staged:
        out.copy_(buf)
        nbytes = 2 * out.numel() * out.element_size()
    _count("all-reduce", out, axis, nbytes)
    return out


def broadcast(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """``x`` of the rank at index ``src`` along ``axis``, on every rank of
    it (others pass a tensor of the same shape and dtype to receive
    into; it is overwritten)."""
    if axis.size == 1:
        return x
    import torch.distributed as dist
    x = x.contiguous()
    staged = _staged("broadcast", axis, x)
    buf = _to_host(x) if staged else x
    dist.broadcast(buf, src=axis.global_rank(src), group=axis.group)
    nbytes = 0
    if staged:
        x.copy_(buf)
        nbytes = 2 * x.numel() * x.element_size()
    _count("broadcast", x, axis, nbytes)
    return x


def broadcast_object(obj: Any, axis: Axis, src: int) -> Any:
    """The picklable ``obj`` of the rank at index ``src`` along ``axis``,
    on every rank of it (the others pass anything). Counted by its
    pickled bytes, which never touch the card."""
    if axis.size == 1:
        return obj
    import pickle
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=axis.global_rank(src),
                               group=axis.group)
    _count("broadcast-object", None, axis, 0, wire_kind="broadcast",
           nbytes=len(pickle.dumps(box[0])))
    return box[0]


def send(x: torch.Tensor, axis: Axis, dst: int) -> None:
    """Send ``x`` to the rank at index ``dst`` along ``axis`` (blocking)."""
    import torch.distributed as dist
    x = x.contiguous()
    staged = _staged("send", axis, x)
    dist.send(_to_host(x) if staged else x, dst=axis.global_rank(dst),
              group=axis.group)
    _count("send", x, axis, x.numel() * x.element_size() if staged else 0,
           wire_kind="collective-permute")


def recv(out: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Receive into ``out`` from the rank at index ``src`` along ``axis``
    (blocking); returns ``out``. The wire bytes are the sender's."""
    import torch.distributed as dist
    staged = _staged("recv", axis, out)
    buf = torch.empty(out.shape, dtype=out.dtype,
                      pin_memory=True) if staged else out
    dist.recv(buf, src=axis.global_rank(src), group=axis.group)
    if staged:
        out.copy_(buf)
    _count("recv", out, axis, out.numel() * out.element_size()
           if staged else 0, wire_kind="")
    return out


def comm_report(fn: Callable, args: Sequence = ()) -> Dict[str, Any]:
    """Run ``fn(*args)`` once with the counters reset and every call
    recorded, and account its collectives under quip_tpu's keys
    (``group``: the world size; each recorded call carries its own group
    size and axis, and its wire bytes follow its own group).
    ``per_kind`` adds ``host_staged`` to quip_tpu's count / bytes /
    wire_bytes; ``result`` is what ``fn`` returned."""
    global _RECORD
    reset()
    _RECORD = []
    try:
        result = fn(*args)
        colls = _RECORD
    finally:
        _RECORD = None
    import torch.distributed as dist
    group = dist.get_world_size() if dist.is_initialized() else 1
    per_kind = {k: dict(v) for k, v in _COUNTS.items() if v["count"]}
    return {
        "group": group,
        "n_collectives": len(colls),
        "per_kind": per_kind,
        "total_result_bytes": sum(c["bytes"] for c in colls),
        "total_wire_bytes": sum(v["wire_bytes"] for v in per_kind.values()),
        "collectives": colls,
        "result": result,
    }


# The H100 SXM data sheet's figures (not a measurement): HBM3 3.35 TB/s,
# NVLink 900 GB/s in both directions, 450 GB/s each way.
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0


def scaling_estimate(report: Dict[str, Any], *, compute_bytes_per_chip: int,
                     hbm_gbps: float = H100_HBM_GBPS,
                     ici_gbps: float = H100_NVLINK_GBPS) -> Dict[str, Any]:
    """Roofline scaling estimate for a bandwidth-bound decode step
    (quip_tpu's arithmetic and keys; the link is NVLink here, still named
    ``ici`` in the keys). compute_bytes_per_chip: the bytes each card
    streams a step. Step time ~ max(memory stream, link wire), overlap
    losses ignored: an OPTIMISTIC bound, reported as such. The defaults are
    the H100 data sheet's rates, not measurements."""
    t_hbm = compute_bytes_per_chip / (hbm_gbps * 1e9)
    t_ici = report["total_wire_bytes"] / (ici_gbps * 1e9)
    t_step = max(t_hbm, t_ici) + 0.0
    eff = t_hbm / t_step if t_step > 0 else 1.0
    return {
        "t_hbm_us": t_hbm * 1e6,
        "t_ici_us": t_ici * 1e6,
        "bound": "ici" if t_ici > t_hbm else "hbm",
        "parallel_efficiency_bound": eff,
        "note": "optimistic overlap-free roofline; serial dispatch and "
                "latency-bound collectives can only lower this",
    }
