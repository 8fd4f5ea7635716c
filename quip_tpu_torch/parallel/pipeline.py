"""Micro-batched pipeline-parallel forward (GPipe) over a 'pp' mesh (port
of ``quip_tpu/parallel/pipeline.py``).

Each rank owns a contiguous slice of n_layers / pp blocks
(``parallel/mesh.py::shard_params_pp``, or ``shard_params_pp_tp`` with
each stage's linears tp-sharded within it); the embedding and the head are
replicated. M micro-batches stream through the stages: stage s runs
micro-batch m at tick m + s, so the schedule takes M + pp - 1 ticks with a
bubble of (pp - 1) / (M + pp - 1). quip_tpu moves the boundary
activations by ``lax.ppermute`` on every tick of one ``shard_map``
program; here each stage receives a micro-batch's activation from the
stage before it (``recv``), runs its blocks, and sends the result on
(``send``), so only the M real hops cross each link. The last stage's
hidden states are broadcast over pp at the end, so every rank returns
them, as quip_tpu's replicated output.

Scope, as quip_tpu's: the full-sequence forward (prefill, calibration,
evaluation); decode stays on the tp path.
"""
from __future__ import annotations

from typing import Dict

import torch

from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.parallel import comm


def pipelined_hidden(params: M.Model, x: torch.Tensor, cfg: ModelConfig,
                     mesh, microbatches: int) -> torch.Tensor:
    """Run the block stack over x (B, S, D) with GPipe pipelining over the
    'pp' axis of ``mesh``; ``params`` is this rank's stage
    (``shard_params_pp`` / ``shard_params_pp_tp``). Requires B %
    microbatches == 0 and n_layers % pp == 0. Returns the final hidden
    states (B, S, D) on every rank."""
    pp = mesh.axis("pp")
    B, S, D = x.shape
    Mn = microbatches
    if B % Mn:
        raise ValueError(f"batch {B} is not divisible by microbatches {Mn}")
    if cfg.n_layers % pp.size:
        raise ValueError(f"n_layers={cfg.n_layers} is not divisible by "
                         f"pp={pp.size}")
    Bm = B // Mn
    dev = x.device
    positions = torch.arange(S, device=dev).expand(Bm, S)
    mask = M.causal_mask(Bm, S, dev)
    plen = torch.full((Bm,), S, dtype=torch.int32, device=dev)
    cs = M.position_tables(cfg, positions)
    stage, last = pp.index, pp.size - 1
    out = torch.empty_like(x) if stage == last else None
    for m in range(Mn):                    # stage s: tick m + s
        if stage == 0:
            h = x[m * Bm:(m + 1) * Bm]
        else:
            h = comm.recv(torch.empty((Bm, S, D), dtype=x.dtype, device=dev),
                          pp, stage - 1)
        for bp in params.blocks:
            h, _ = M.block_apply(bp, h, cfg, positions, mask, rope_cs=cs,
                                 plen=plen)
        if stage < last:
            comm.send(h, pp, stage + 1)
        else:
            out[m * Bm:(m + 1) * Bm] = h
    if pp.size == 1:
        return out
    if out is None:
        out = torch.empty_like(x)
    return comm.broadcast(out, pp, last)


def pipelined_forward(params: M.Model, tokens: torch.Tensor,
                      cfg: ModelConfig, mesh, microbatches: int = 4
                      ) -> torch.Tensor:
    """Full pipelined forward -> logits (B, S, V): the embedding and the
    head replicated, the block stack on the GPipe schedule."""
    B, S = tokens.shape
    M.check_positions(params, cfg, S)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = M.embed(params, tokens, cfg, positions)
    x = pipelined_hidden(params, x, cfg, mesh, microbatches)
    return M.unembed(params, x, cfg)


def pipeline_comm_bytes(cfg: ModelConfig, batch: int, seq: int,
                        microbatches: int, pp: int,
                        dtype_bytes: int = 2) -> Dict[str, float]:
    """quip_tpu's analytic boundary traffic of one prefill (copied): each
    of M + pp - 1 ticks moves one (B/M, S, D) activation across each of
    pp-1 stage links. The port's schedule sends only the M real hops of a
    link (M / (M + pp - 1) of this total)."""
    Bm = batch // microbatches
    hop = Bm * seq * cfg.d_model * dtype_bytes
    ticks = microbatches + pp - 1
    return {
        "hop_bytes": float(hop),
        "ticks": ticks,
        "bubble_fraction": (pp - 1) / ticks,
        "total_wire_bytes": float(hop * ticks * max(pp - 1, 0)),
    }
