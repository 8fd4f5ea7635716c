"""Quantized-linear forward: the incoherence-aware inference op.

Port of ``quip_tpu/ops/qlinear.py``. y = x @ Ŵᵀ with
Ŵ = Uᵀ Ŵ₂ V · diag(1/s) folded into the activation path:

    y = ((x / s) @ Vᵀ) @ Ŵ₂ᵀ @ U

Steps: V-side rotation -> packed dequant-matmul (kernels/dequant_matmul.py:
the CUDA kernel for CUDA tensors, its plain version on the CPU) -> U-side
rotation. The dense rotated weight is never built. RHT modes ('rht',
'rht_sf', 'rht_uf') fold the un-scale and the V signs into one vector
(``rot['vin']``); butterfly modes ('block', 'noblock', 'nopermute') divide
by scaleWH, then apply V's butterfly (gathers by the permutations and a
batched product a stage), and U's transposed after the kernel, gathering
by the inverse permutations the layer derived at construction: no host
sync and no argsort a call, so the branch is captured in the serving
graphs like the others.

Rotations must be materialised (``PackedLinear.rot``): the port does not
regenerate JAX keys (see core/incoherence.py).

``QUIP_FUSED_RHT=1`` (read at call time, default off, the same variable as
in quip_tpu) sends 'rht'-mode layers at decode-size batches (at most 32
rows) through the fused RHT kernel (kernels/rht.py): one launch per
rotation instead of the multiply, two matmuls and their casts.

Tensor parallelism (parallel/mesh.py) wraps a block's linears in
:class:`TPLinear`. A packed linear is column-parallel, as quip_tpu's
``_packed_linear_spec`` has it: the V side runs on the replicated x, K1 on
this rank's (nwords, m_p / tp) column shard, one all-gather over tp gives
(B, m_p), then the slice to out_features, the U side on the whole vector
and the bias: what GSPMD inserts around quip_tpu's ``_dm_partitioned``.
A dense linear is Megatron's: column-parallel (its output stays a shard)
or row-parallel (its input is a shard; one all-reduce).
"""
from __future__ import annotations

import os
import weakref

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.kernels.dequant_matmul import dequant_matmul
from quip_tpu_torch.kernels.rht import refresh as refresh_rht
from quip_tpu_torch.kernels.rht import rht_apply_fused
from quip_tpu_torch.ops.actquant import ActQuant
from quip_tpu_torch.pack.format import PackedLinear, rot_to_butterflies
from quip_tpu_torch.parallel import comm


def _fused_rht_enabled() -> bool:
    return os.environ.get("QUIP_FUSED_RHT") == "1"


_vins: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fused_vin(q: PackedLinear, signs: torch.Tensor) -> torch.Tensor:
    """signs / scaleWH of a layer that stores no ``vin``, made once per
    layer rather than a call, so that K3 finds its bf16 copies cached
    (kernels/rht.py::operands keys them by the tensor). A write in place to
    either since is divided again into the same tensor, which a captured
    CUDA graph reads through those copies. Not cached while a graph is
    being captured, and a stale one then raises."""
    swh = q.scaleWH
    stamp = (signs.data_ptr(), signs._version, swh.data_ptr(), swh._version)
    got = _vins.get(q)
    capturing = signs.is_cuda and torch.cuda.is_current_stream_capturing()
    if got is not None and got[1].device == signs.device:
        if got[0] != stamp:
            if capturing:
                raise RuntimeError(
                    "qlinear: signs or scaleWH were written in place since "
                    "the fused vec was made; call refresh_fused() before "
                    "capturing")
            torch.div(signs, swh, out=got[1])
            got[0] = stamp
        return got[1]
    vin = signs / swh
    if not capturing:
        _vins[q] = [stamp, vin]
    return vin


def refresh_fused(q: PackedLinear) -> None:
    """Bring the fused path's derived state up to date with buffers of
    ``q`` written in place (``PackedLinear`` calls this after
    ``load_state_dict``): its signs / scaleWH and every cached bf16 copy of
    K3's operands, each in its own tensor, so CUDA graphs captured before
    read the new values from their next replay."""
    if q in _vins and q.scaleWH is not None and q.v_signs is not None:
        _fused_vin(q, q.v_signs)
    refresh_rht()


def _packed_matmul(q: PackedLinear, x2: torch.Tensor,
                   gather=None) -> torch.Tensor:
    """x2 (B, d) @ Ŵ₂ᵀ, sliced from the padded planes to out_features;
    ``gather`` (a column shard's) joins the shards' columns first."""
    if q.qfn == "b":
        scale, zero = q.scale_b, None
    else:
        scale, zero = q.scale, q.zero
    out = dequant_matmul(x2, q.planes, scale, zero, bits=q.bits, qfn=q.qfn,
                         code_bits=q.code_bits)
    if gather is not None:
        out = gather(out)
    if out.shape[-1] != q.out_features:
        out = out[:, : q.out_features]     # padded_m rows are dead
    return out


def qlinear_apply(q: PackedLinear, x: torch.Tensor,
                  gather=None) -> torch.Tensor:
    """Apply a packed quantized linear to x (..., in_features). ``q`` may
    be a column shard (parallel/mesh.py::shard_packed) whose ``gather``
    joins its K1 output over tp before the U side."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    if d != q.in_features:
        raise ValueError(f"qlinear: x has {d} features, layer takes "
                         f"{q.in_features}")
    x2 = x.reshape(-1, d)

    if (q.proj_mode == "rht" and q.has_rot and x2.shape[0] <= 32
            and _fused_rht_enabled()):
        # fused path: one kernel per rotation (vec fold + both Kronecker
        # products); vec_v carries the scaleWH divide (stored as vin).
        # quip_tpu pads the rows to a multiple of 8 here for the TPU's
        # sublane tiling; rows are independent, so this kernel takes them
        # as they are.
        U, V = rot_to_butterflies(q)
        if q.has_vin:
            vec_v = q.vin
        elif q.scaleWH is None:
            vec_v = V.signs
        else:
            vec_v = _fused_vin(q, V.signs)
        x2 = rht_apply_fused(x2, vec_v, V.left, V.right)
        t = _packed_matmul(q, x2, gather)
        y = rht_apply_fused(t, U.signs, U.left, U.right, transpose=True)
    elif q.butterfly:
        if q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        U, V = rot_to_butterflies(q)
        x2 = inc.apply_butterfly(V, x2, axis=-1)         # x @ Vᵀ
        t = _packed_matmul(q, x2, gather)
        y = inc.apply_butterfly(U, t, axis=-1, transpose=True)  # @ U
    elif not q.has_rot:
        if q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        y = _packed_matmul(q, x2, gather)
    else:
        U, V = rot_to_butterflies(q)
        if q.has_vin:
            # folded fast path: vin = signs_V / scaleWH is ONE pass
            V = V._replace(signs=q.vin)
        elif q.scaleWH is not None:
            x2 = x2 / q.scaleWH.to(x2.dtype)[None, :]
        x2 = inc.apply_rht(V, x2, axis=-1)               # x @ Vᵀ
        t = _packed_matmul(q, x2, gather)
        y = inc.apply_rht(U, t, axis=-1, transpose=True)  # @ U

    if q.bias is not None:
        y = y + q.bias.to(y.dtype)
    return y.reshape(*lead, q.out_features)


class TPLinear(torch.nn.Module):
    """A tensor-parallel linear (made by parallel/mesh.py::shard_block):
    ``inner`` is this rank's shard (a PackedLinear column shard or a dense
    tensor, optionally in an ActQuant), ``layout`` how it runs:

      * 'gather': a packed column shard; takes the whole x, gives the whole
        y (one all-gather over ``axis`` inside, before the U side);
      * 'col': dense columns; takes the whole x, gives its column shard;
      * 'row': dense rows; takes its shard of x, gives the whole y (one
        all-reduce over ``axis``)."""

    def __init__(self, inner, layout: str, axis: comm.Axis):
        super().__init__()
        if layout not in ("gather", "col", "row"):
            raise ValueError(f"TPLinear: unknown layout {layout!r}")
        if isinstance(inner, torch.nn.Module):
            self.inner = inner
        else:
            self.register_buffer("inner", inner)
        self.layout = layout
        self.axis = axis

    @property
    def takes_shard(self) -> bool:
        return self.layout == "row"

    @property
    def gives_shard(self) -> bool:
        return self.layout == "col"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self, x)


def _tp_apply(w: TPLinear, x: torch.Tensor) -> torch.Tensor:
    inner = w.inner
    if isinstance(inner, ActQuant):
        x, inner = inner.quantize(x), inner.inner
    if w.layout == "gather":
        return qlinear_apply(
            inner, x, gather=lambda t: comm.all_gather(t, w.axis, dim=-1))
    if w.layout == "col":
        return x @ inner
    return comm.all_reduce(x @ inner, w.axis)


def linear_apply(w, x: torch.Tensor) -> torch.Tensor:
    """Dense-or-packed dispatch: a dense weight is stored (in, out) as in
    quip_tpu, so y = x @ w. An ActQuant wrapper (ops/actquant.py)
    quantizes the activations first, then dispatches its inner linear; a
    TPLinear runs its shard with its collective."""
    if isinstance(w, TPLinear):
        return _tp_apply(w, x)
    if isinstance(w, ActQuant):
        return linear_apply(w.inner, w.quantize(x))
    if isinstance(w, PackedLinear):
        return qlinear_apply(w, x)
    if isinstance(w, torch.Tensor):
        return x @ w
    raise TypeError(f"linear_apply: no dispatch for a "
                    f"{type(w).__name__} leaf")
