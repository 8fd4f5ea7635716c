"""Layer-streaming calibration + quantization driver.

Port of ``quip_tpu/quantize/driver.py`` (reference opt_sequential
opt.py:29-190, llama_sequential llama.py:36-171):

  * No forward hooks: ``block_apply(with_taps=True)`` returns each
    linear's input; Hessians are shared per tap point (q/k/v read the same
    activations).
  * Per block, as opt.py:94-181: accumulate H over the calibration samples
    in chunks -> quantize each linear -> replay the block with the
    quantized weights to make the next block's inputs.
  * The calibration forward passes ``plen``: its mask is exactly causal
    over whole windows, so on the card windows of 512 tokens or more take
    the flash prefill kernel (K2) instead of (chunk, H, S, S) logits.
  * H accumulates in true f32 (TF32 off, utils.f32_matmuls), as quip_tpu
    accumulates at Precision.HIGHEST, whatever the model's dtype.

Randomness: each linear's rotation pair (U, V) and unbiased dither come
from a ``torch.Generator`` seeded with ``seed`` and the linear's
``name_salt`` (quip_tpu folds the same salt into its key); a ``rotations``
callable ``(name, m, d) -> (U, V)`` can supply the pairs instead (the
parity tests replay quip_tpu's own).

Not ported yet (ROADMAP queue 1 item 8): ``resume_dir``, ``host_offload``
and ``save_hessians``; asking for the first two raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Collection, Dict, Optional, Tuple, Union

import torch

from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.quantize.config import QuantConfig
from quip_tpu_torch.quantize.pipeline import LayerQuantResult, quantize_layer
from quip_tpu_torch.utils import f32_matmuls, name_salt

Rotations = Callable[[str, int, int], Tuple[inc.RHT, inc.RHT]]


@dataclass
class QuantizedModelArtifacts:
    """Per-layer results of the driver (the reference's ``quantizers`` dict
    + errors/Hmags/times lists, opt.py:92-93, 164-170). ``times`` holds
    quip_tpu's keys ('layers.{i}': Hessian pass + solves, 'lm_head');
    ``linear_times`` the seconds of each linear's solve; ``phase_times``
    each layer's (Hessian pass, solves, replay) seconds."""

    results: Dict[str, LayerQuantResult] = field(default_factory=dict)
    errors: Dict[str, float] = field(default_factory=dict)
    Hmags: Dict[str, float] = field(default_factory=dict)
    times: Dict[str, float] = field(default_factory=dict)
    hessians: Dict[str, torch.Tensor] = field(default_factory=dict)
    linear_times: Dict[str, float] = field(default_factory=dict)
    phase_times: Dict[str, Tuple[float, float, float]] = field(
        default_factory=dict)

    @property
    def total_error(self) -> float:
        return float(sum(self.errors.values()))


def layer_generator(seed: int, name: str) -> torch.Generator:
    """The CPU generator of one linear: seeded with the run's seed and the
    linear's name_salt, so a layer's rotations do not depend on the order
    or the device it is quantized on."""
    return torch.Generator().manual_seed(seed * 2 ** 32 + name_salt(name))


def _clock(dev: torch.device) -> float:
    """Host seconds after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _block_inputs(params: M.Model, cfg: ModelConfig, tokens: torch.Tensor,
                  chunk: int = 8) -> torch.Tensor:
    """Block-0 inputs for all calibration samples (the functional Catcher,
    opt.py:55-73), each window at positions 0..S-1 (OPT's learned table
    reads them). tokens: (N, S) on the model's device."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    return torch.cat([
        M.embed(params, tk, cfg, pos.expand(tk.shape[0], S))
        for tk in tokens.split(chunk)])


def _make_block_fns(cfg: ModelConfig, seqlen: int, chunk: int,
                    device: torch.device):
    """(accumulate, replay) over one chunk of windows, with the causal mask,
    the RoPE tables (rope family) and ``plen`` built once for every
    layer."""
    positions = torch.arange(seqlen, device=device).expand(chunk, seqlen)
    mask = M.causal_mask(chunk, seqlen, device)
    plen = torch.full((chunk,), seqlen, dtype=torch.int32, device=device)
    cs = M.position_tables(cfg, positions)

    def accumulate(layer: M.Block, inps: torch.Tensor,
                   H: Dict[str, torch.Tensor]) -> None:
        """Run the block over a chunk; H[tap] += xᵀx (unnormalized, f32)."""
        _, _, taps = M.block_apply(layer, inps, cfg, positions, mask,
                                   rope_cs=cs, plen=plen, with_taps=True)
        with f32_matmuls():
            for name, x in taps.items():
                xt = x.reshape(-1, x.shape[-1]).to(torch.float32)
                if name not in H:
                    H[name] = torch.zeros((xt.shape[1],) * 2,
                                          dtype=torch.float32, device=device)
                H[name] += xt.t() @ xt

    def replay(layer: M.Block, inps: torch.Tensor) -> torch.Tensor:
        return M.block_apply(layer, inps, cfg, positions, mask, rope_cs=cs,
                             plen=plen)[0]

    return accumulate, replay


def _quantize_one(W, H, qcfg, name, seed, rotations):
    """quantize_layer on one linear, naming it in a Cholesky failure."""
    gen = layer_generator(seed, name)
    rot = rotations(name, *W.shape) if rotations is not None else None
    try:
        return quantize_layer(W, H, qcfg, rot=rot, gen=gen)
    except torch.linalg.LinAlgError as e:
        raise torch.linalg.LinAlgError(f"{name}: {e}") from e


def quantize_model(
    params: M.Model,
    cfg: ModelConfig,
    calib_tokens: torch.Tensor,            # (nsamples, seqlen) integer
    qcfg: QuantConfig,
    *,
    seed: int = 0,
    rotations: Optional[Rotations] = None,
    chunk: int = 4,
    keep_hessians: Union[bool, Collection[str]] = False,
    layer_filter: Optional[Collection[str]] = None,
    progress: bool = False,
    resume_dir: Optional[str] = None,
    host_offload: bool = False,
    quant_head: bool = False,
) -> Tuple[M.Model, QuantizedModelArtifacts]:
    """Quantize every linear of every block, layer-streaming, on the
    model's device. Returns (a new Model holding the dequantized weights,
    artifacts); ``params`` is left as it was.

    ``layer_filter``: linear names (spec names) to quantize, the others
    stay. ``keep_hessians``: True keeps every linear's H in the artifacts,
    a collection of full names ('layers.0.mlp.down_proj', 'lm_head') keeps
    those. ``quant_head``: also quantize the (untied) lm_head against the
    Hessian of its true input (the final norm of the quantized model's
    last-block outputs)."""
    if resume_dir or host_offload:
        raise NotImplementedError(
            "resume_dir / host_offload are not ported yet (ROADMAP queue 1 "
            "item 8)")
    if quant_head and (cfg.tie_word_embeddings or params.lm_head is None):
        raise ValueError(
            "quant_head requires an untied lm_head: tied families reuse the "
            "token table, which must stay dense for the embedding gather")
    if qcfg.wbits >= 16:
        return params, QuantizedModelArtifacts()

    N, S = calib_tokens.shape
    if N % chunk:
        raise ValueError(f"nsamples {N} must be divisible by chunk {chunk}")
    dev = params.embed.tokens.device
    fused = params.blocks[0].attn.fused
    specs = M.linear_specs(cfg, fused=fused)
    art = QuantizedModelArtifacts()

    def keep(name: str) -> bool:
        return keep_hessians is True or (
            not isinstance(keep_hessians, bool) and name in keep_hessians)

    def record(name, res, H):
        art.errors[name] = float(res.error)
        art.Hmags[name] = float(res.Hmag)
        art.results[name] = res
        if keep(name):
            art.hessians[name] = H

    calib_tokens = calib_tokens.to(dev)
    inps = _block_inputs(params, cfg, calib_tokens, chunk)
    accumulate, replay = _make_block_fns(cfg, S, chunk, dev)
    new_blocks = []
    n_layers = cfg.n_layers

    for li, block in enumerate(params.blocks):
        t0 = _clock(dev)
        # --- pass 1: accumulate tap Hessians (opt.py:131-148) ---
        H: Dict[str, torch.Tensor] = {}
        for i in range(0, N, chunk):
            accumulate(block, inps[i:i + chunk], H)
        # normalize by the number of sequences (method.py:122-123)
        H = {k: v / N for k, v in H.items()}
        t1 = _clock(dev)

        # --- quantize each linear (opt.py:150-170) ---
        def quantize(spec, Wm, li=li, H=H):
            name = f"layers.{li}.{spec.name}"
            ts = _clock(dev)
            # the model stores (in, out); the solver wants (m=out, d=in)
            res = _quantize_one(Wm.t(), H[spec.tap], qcfg, name, seed,
                                rotations)
            art.linear_times[name] = _clock(dev) - ts
            record(name, res, H[spec.tap])
            return res.W_hat.t().to(Wm.dtype)

        new_block = M.replace_linears(
            block, [sp for sp in specs
                    if layer_filter is None or sp.name in layer_filter],
            quantize)
        new_blocks.append(new_block)
        del H, quantize
        t2 = _clock(dev)
        art.times[f"layers.{li}"] = t2 - t0

        # --- pass 2: replay with quantized weights (opt.py:172-174) ---
        out = torch.empty_like(inps)
        for i in range(0, N, chunk):
            out[i:i + chunk] = replay(new_block, inps[i:i + chunk])
        inps = out
        t3 = _clock(dev)
        art.phase_times[f"layers.{li}"] = (t1 - t0, t2 - t1, t3 - t2)
        if progress:
            err = sum(v for k, v in art.errors.items()
                      if k.startswith(f"layers.{li}."))
            per = ", ".join(f"{k.split('.', 2)[2]} {v:.2f}s"
                            for k, v in art.linear_times.items()
                            if k.startswith(f"layers.{li}."))
            print(f"[quantize] layer {li + 1}/{n_layers} error={err:.4f} "
                  f"t={t2 - t0:.1f}s (hessian {t1 - t0:.1f}s; {per}; "
                  f"replay {t3 - t2:.1f}s)", flush=True)

    head = params.lm_head
    if quant_head:
        t0 = _clock(dev)
        Hh = None
        with f32_matmuls():
            for i in range(0, N, chunk):
                z = M.head_input(params, inps[i:i + chunk], cfg)
                zt = z.reshape(-1, z.shape[-1]).to(torch.float32)
                up = zt.t() @ zt
                Hh = up if Hh is None else Hh + up
        Hh = Hh / N
        res = _quantize_one(head.t(), Hh, qcfg, "lm_head", seed, rotations)
        head = res.W_hat.t().to(getattr(torch, cfg.dtype))
        record("lm_head", res, Hh)
        art.times["lm_head"] = art.linear_times["lm_head"] = \
            _clock(dev) - t0
        if progress:
            print(f"[quantize] lm_head error={art.errors['lm_head']:.4f} "
                  f"t={art.times['lm_head']:.1f}s", flush=True)

    return (M.Model(cfg, params.embed, new_blocks, params.final_ln, head),
            art)
