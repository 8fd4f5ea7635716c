"""Per-layer quantization pipeline: preproc -> grid -> round -> postproc.

Port of ``quip_tpu/quantize/pipeline.py``: the single entry replacing the
reference's QuantMethod classes (Balance bal.py:13-48, Nearest
near.py:5-20, GPTQ gptq.py:17-116) and the rounding dispatcher
quantize_weight_vecbal (vector_balance.py:499-532).

Randomness: the rotation pair (U, V) is given as drawn, or drawn from a
``torch.Generator``, which also supplies the unbiased dither. The whole
function runs with TF32 off (utils.f32_matmuls): the Cholesky factors and
error recurrences need true f32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from quip_tpu_torch.core import grid as grid_mod
from quip_tpu_torch.core import hessian as hess
from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.core import ldlq
from quip_tpu_torch.core.gptq import gptq_round
from quip_tpu_torch.core.grid import GridParams
from quip_tpu_torch.quantize.config import QuantConfig
from quip_tpu_torch.utils import f32_matmuls


class LayerQuantResult(NamedTuple):
    """Everything produced by quantizing one linear layer."""

    W_hat: torch.Tensor                 # dequantized weights, original space
    codes: Optional[torch.Tensor]       # integer grid codes (rotated), uint8
    grid: Optional[GridParams]          # qfn-a/c grid parameters
    qfnb_scale: Optional[torch.Tensor]  # scalar scale for qfn-b
    preproc: hess.PreprocState          # inverse state (scale, U, V)
    error: torch.Tensor                 # proxy loss tr(ΔW H ΔWᵀ), rotated
    Hmag: torch.Tensor                  # max H after preproc (method.py:233)


def _round_on_grid(gen, Wg, H, cfg: QuantConfig):
    """Dispatch to the adaptive-rounding solvers (vector_balance.py:426-496)."""
    m = cfg.method
    if m == "ldlq":
        return ldlq.round_ldl(Wg, H, cfg.wbits, cfg.npasses, cfg.unbiased,
                              gen, cfg.blocksize)
    if m == "ldlqRG":
        return ldlq.round_ldlqRG(Wg, H, cfg.wbits, cfg.npasses, cfg.unbiased,
                                 gen, cfg.blocksize)
    if m == "allbal":
        return ldlq.round_allbal_sorted(Wg, H, cfg.wbits, cfg.npasses,
                                        cfg.unbiased, gen, cfg.blocksize)
    if m == "ldlbal_admm":
        return ldlq.round_ldl_admm_sorted(Wg, H, cfg.wbits, cfg.npasses,
                                          cfg.unbiased, gen)
    if m == "ldl_gptqequiv":
        return ldlq.round_ldl_gptqequiv(Wg, H, cfg.wbits, cfg.unbiased, gen,
                                        cfg.blocksize)
    if m == "nearest":
        return ldlq.round_nearest(Wg, cfg.wbits)
    raise ValueError(f"method {cfg.method!r} is not a grid solver")


# (U, V) of an (m, d) weight drawn from a generator: RHTs, or butterflies
# for the butterfly modes (f32 on the generator's device)
draw_rotation = inc.gen_pair


def quantize_layer(W: torch.Tensor, H: torch.Tensor, cfg: QuantConfig,
                   rot: Optional[Tuple[hess.Transform,
                                       hess.Transform]] = None,
                   gen: Optional[torch.Generator] = None
                   ) -> LayerQuantResult:
    """Quantize one (m, d) weight matrix against its (d, d) proxy Hessian.

    Follows the reference lifecycle (opt.py:150-170): preproc
    (method.py:125-193) -> grid parameters -> adaptive rounding
    (vector_balance.py:499-532 / gptq.py:19-116) -> postproc
    (method.py:195-214) -> proxy error (method.py:228-233).

    ``rot``: the rotation pair (U, V) that preprocessing applies; drawn
    from ``gen`` when None (incoherence configs need one or the other).
    ``gen`` also draws the unbiased dither."""
    if cfg.preproc.proj and rot is None:
        if gen is None:
            raise ValueError("incoherence processing needs the rotation "
                             "pair or a torch.Generator to draw it")
        rot = draw_rotation(gen, *W.shape, cfg.preproc.proj_mode)
    if rot is not None:
        rot = tuple(inc.transform_to(r, W.device) for r in rot)
    with f32_matmuls():
        return _quantize_layer_inner(W, H, cfg, rot, gen)


def _quantize_layer_inner(W, H, cfg, rot, gen):
    W0 = W.to(torch.float32) if W.dtype in (torch.bfloat16,
                                            torch.float16) else W
    H = H.to(dtype=W0.dtype, device=W0.device)

    pp = cfg.preproc
    Wp, Hp, state = hess.preproc(
        W0, H, rescale=pp.rescale, proj=pp.proj, rot=rot,
        proj_mode=pp.proj_mode, gptqH=pp.gptqH, percdamp=pp.percdamp)

    maxq = float(2 ** cfg.wbits - 1)
    codes = None
    gp: Optional[GridParams] = None
    scale_b = None

    if cfg.method in ("gptq", "trueobs"):
        # "trueobs" (zeroShot/models/fast_trueobs.py:59-165) is the blocked
        # OPTQ recursion with the fp-outlier escape on by default
        # (threshold 0.25·scale², fast_trueobs.py:108, 134-139); its
        # running-average Hessian differs from the summed one by a scale,
        # which the recursion is invariant to
        sparse = cfg.sparse_outlier
        if cfg.method == "trueobs" and sparse == 0.0:
            sparse = 0.25
        if cfg.qfn in ("a", "c"):
            gp = grid_mod.find_params_qfna(Wp, cfg.wbits, perchannel=True,
                                           sym=False)
        else:  # qfn 'b': per-column scale computed inside the solver
            ones = torch.ones((Wp.shape[0], 1), dtype=Wp.dtype,
                              device=Wp.device)
            gp = GridParams(scale=ones, zero=torch.zeros_like(ones),
                            maxq=maxq)
        What_p = gptq_round(Wp, Hp, gp, cfg.qfn, cfg.blocksize,
                            cfg.groupsize, sparse)
        if cfg.qfn in ("a", "c") and cfg.groupsize == -1 and sparse == 0.0:
            # integer codes for packing, recovered from the grid
            # (quant.py:190-191); none where per-group grids or kept fp
            # outliers make the layer unpackable
            codes = torch.clamp(torch.round(What_p / gp.scale + gp.zero),
                                0, maxq)
    elif cfg.qfn == "a":
        gp = grid_mod.find_params_qfna(Wp, cfg.wbits, perchannel=True,
                                       sym=False)
        if cfg.method == "ldl_gptqequiv":
            # no pre-clamp on the equivalence path (vector_balance.py:510-513)
            Wg = Wp / gp.scale + gp.zero
        else:
            Wg = grid_mod.to_grid_qfna(Wp, gp)
        codes = _round_on_grid(gen, Wg, Hp, cfg)
        What_p = grid_mod.from_grid_qfna(codes, gp)
    elif cfg.qfn == "b":
        scale_b = grid_mod.qfnb_scale(Wp)      # 2.4·RMS after preproc
        if cfg.method == "nearest":
            What_p = grid_mod.quantize_qfnb(Wp, scale_b, maxq)
            codes = torch.clamp(
                torch.round(((Wp / scale_b + 1) / 2) * maxq), 0, maxq)
        else:
            Wg = grid_mod.to_grid_qfnb(Wp, scale_b, maxq)
            codes = _round_on_grid(gen, Wg, Hp, cfg)
            What_p = grid_mod.from_grid_qfnb(codes, scale_b, maxq)
    elif cfg.qfn == "c":
        gp = grid_mod.find_params_qfna(Wp, cfg.wbits, perchannel=True,
                                       sym=False)
        What_p = grid_mod.quantize_qfnc(Wp, gp.scale, gp.zero, maxq)
        codes = torch.round(torch.clamp(Wp / gp.scale + gp.zero, 0, maxq))
    else:
        raise ValueError(f"unsupported qfn {cfg.qfn!r}")

    # proxy loss in the preprocessed space, tr(ΔW Hp ΔWᵀ): by orthogonal
    # invariance the loss in the original space against the damped H
    error = ldlq.hessian_loss(Wp - What_p, Hp)
    Hmag = Hp.max()

    What, _ = hess.postproc(What_p, None, state)
    return LayerQuantResult(
        W_hat=What.to(W.dtype),
        codes=None if codes is None else codes.to(torch.uint8),
        grid=gp, qfnb_scale=scale_b, preproc=state, error=error, Hmag=Hmag)


def dequantize_result(res: LayerQuantResult, bits: int,
                      dtype=torch.float32) -> torch.Tensor:
    """The result's Ŵ rebuilt from its ``bits``-bit codes in ``dtype``
    (postproc of the grid's values): the dense weight the packed form must
    reproduce."""
    codes = res.codes.to(dtype)
    if res.qfnb_scale is not None:
        Wq = grid_mod.from_grid_qfnb(codes, res.qfnb_scale.to(dtype),
                                     float(2 ** bits - 1))
    else:
        g = res.grid
        Wq = grid_mod.from_grid_qfna(
            codes, GridParams(g.scale.to(dtype), g.zero.to(dtype), g.maxq))
    st = res.preproc
    if st.scaleWH is not None:
        st = st._replace(scaleWH=st.scaleWH.to(dtype))
    return hess.postproc(Wq, None, st)[0]

