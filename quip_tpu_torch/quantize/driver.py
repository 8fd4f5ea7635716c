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

``resume_dir`` writes each finished block to ``resume_dir/layer_{i}.npz``
in quip_tpu's format (its leaves in quip_tpu's flatten order), so a run
resumes a directory that either package wrote. ``host_offload`` keeps the
blocks and the per-layer artifacts in host memory (pinned where a card
is the compute device) and moves one block at a time to the device.
``save_hessians`` runs the calibration alone.

Data-parallel calibration (``dp``, a parallel/comm.py axis; ``cli/quantize
--dp``): each dp rank runs the calibration forward and the replays on its
contiguous share of the windows, and each tap's Hessian sum is
all-reduced over dp before the division by the number of windows, as
quip_tpu's GSPMD psums them. Every rank then solves from the same seed, so
all ranks hold the same quantized model.
"""
from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Collection, Dict, Optional, Tuple, Union

import numpy as np
import torch

from quip_tpu_torch.core.hessian import Transform
from quip_tpu_torch.core.incoherence import transform_to
from quip_tpu_torch.models import model as M
from quip_tpu_torch.models.config import ModelConfig
from quip_tpu_torch.parallel import comm
from quip_tpu_torch.quantize.config import QuantConfig
from quip_tpu_torch.quantize.pipeline import LayerQuantResult, quantize_layer
from quip_tpu_torch.utils import f32_matmuls, name_salt

Rotations = Callable[[str, int, int], Tuple[Transform, Transform]]


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


def _moved(t, dev, pin: bool = False):
    """A tensor (or a module, copied) on ``dev``; CPU copies pinned with
    ``pin`` where there is a card to copy them to. None stays None."""
    if t is None:
        return None
    if isinstance(t, torch.nn.Module):
        return copy.deepcopy(t).to(dev)
    t = t.to(dev)
    if pin and dev.type == "cpu" and torch.cuda.is_available():
        t = t.pin_memory()
    return t


def _block_to(b: M.Block, dev: torch.device, pin: bool = False) -> M.Block:
    """A new Block holding ``b``'s weights on ``dev`` (``b`` unchanged)."""
    mv = lambda t: _moved(t, dev, pin)  # noqa: E731
    kids = lambda mod, names: {k: mv(getattr(mod, k))  # noqa: E731
                               for k in names if getattr(mod, k) is not None}
    return M.Block(b.ln1.mapped(mv), b.ln2.mapped(mv),
                   M.Attention(**kids(b.attn, M.Attention.NAMES)),
                   M.MLP(**kids(b.mlp, M.MLP.NAMES)))


def _result_to(res: LayerQuantResult, dev: torch.device) -> LayerQuantResult:
    """A LayerQuantResult with every tensor on ``dev``."""
    mv = lambda t: None if t is None else t.to(dev)  # noqa: E731
    st = res.preproc
    st = st._replace(scaleWH=mv(st.scaleWH),
                     U=None if st.U is None else transform_to(st.U, dev),
                     V=None if st.V is None else transform_to(st.V, dev))
    g = res.grid
    if g is not None:
        g = g._replace(scale=mv(g.scale), zero=mv(g.zero))
    return res._replace(W_hat=mv(res.W_hat), codes=mv(res.codes), grid=g,
                        qfnb_scale=mv(res.qfnb_scale), preproc=st,
                        error=mv(res.error), Hmag=mv(res.Hmag))


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
    device=None,
    dp: Optional[comm.Axis] = None,
) -> Tuple[M.Model, QuantizedModelArtifacts]:
    """Quantize every linear of every block, layer-streaming, on
    ``device`` (default: the model's). Returns (a new Model holding the
    dequantized weights, artifacts); ``params`` is left as it was.

    ``layer_filter``: linear names (spec names) to quantize, the others
    stay. ``keep_hessians``: True keeps every linear's H in the artifacts,
    a collection of full names ('layers.0.mlp.down_proj', 'lm_head') keeps
    those. ``quant_head``: also quantize the (untied) lm_head against the
    Hessian of its true input (the final norm of the quantized model's
    last-block outputs).

    ``resume_dir``: each finished block is written to
    ``resume_dir/layer_{i}.npz``; a later run skips the finished layers
    (the block is read back and only replayed to rebuild the activations;
    their results are not in the artifacts, as in quip_tpu).
    ``host_offload``: the blocks stay in host memory (the model may be
    built there) and one at a time moves to ``device``; the quantized
    blocks, the artifacts and the returned model are on the host.

    ``dp``: this rank's data-parallel axis; it calibrates on its
    contiguous nsamples / dp windows in chunks of chunk / dp, and the
    Hessian sums are all-reduced over dp (module docstring)."""
    if quant_head and (cfg.tie_word_embeddings or params.lm_head is None):
        raise ValueError(
            "quant_head requires an untied lm_head: tied families reuse the "
            "token table, which must stay dense for the embedding gather")
    if qcfg.wbits >= 16:
        return params, QuantizedModelArtifacts()

    N, S = calib_tokens.shape
    if N % chunk:
        raise ValueError(f"nsamples {N} must be divisible by chunk {chunk}")
    n_windows = N
    if dp is not None and dp.size > 1:
        if chunk % dp.size:
            raise ValueError(f"chunk {chunk} must be divisible by dp "
                             f"{dp.size}")
        N, chunk = N // dp.size, chunk // dp.size
        calib_tokens = calib_tokens[dp.index * N:(dp.index + 1) * N]

    def reduced(Hsum: torch.Tensor) -> torch.Tensor:
        """A Hessian sum over every window, normalized by their number."""
        if dp is not None:
            Hsum = comm.all_reduce(Hsum, dp)
        return Hsum / n_windows
    home = params.embed.tokens.device
    dev = torch.device(device) if device is not None else home
    host = torch.device("cpu")
    fused = params.blocks[0].attn.fused
    specs = M.linear_specs(cfg, fused=fused)
    art = QuantizedModelArtifacts()

    def keep(name: str) -> bool:
        return keep_hessians is True or (
            not isinstance(keep_hessians, bool) and name in keep_hessians)

    def record(name, res, H):
        art.errors[name] = float(res.error)
        art.Hmags[name] = float(res.Hmag)
        art.results[name] = _result_to(res, host) if host_offload else res
        if keep(name):
            art.hessians[name] = H.to(host) if host_offload else H

    calib_tokens = calib_tokens.to(dev)
    embed = params.embed
    if embed.tokens.device != dev:
        embed = embed.mapped(lambda t: t.to(dev))
    inps = _block_inputs(M.Model(cfg, embed, [], None, None), cfg,
                         calib_tokens, chunk)
    accumulate, replay = _make_block_fns(cfg, S, chunk, dev)
    new_blocks = []
    n_layers = cfg.n_layers
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)
    # the layers to resume, fixed before any rank writes a file (a dp rank
    # must not resume a layer another rank is quantizing with collectives)
    resumable = {li for li in range(n_layers) if resume_dir
                 and os.path.exists(_resume_path(resume_dir, li))}

    def replay_all(block):
        out = torch.empty_like(inps)
        for i in range(0, N, chunk):
            out[i:i + chunk] = replay(block, inps[i:i + chunk])
        return out

    for li, block in enumerate(params.blocks):
        resumed = _load_resume_layer(resume_dir, li, block) \
            if li in resumable else None
        if resumed is not None:
            new_block, saved_err = resumed
            art.errors.update(saved_err)
            inps = replay_all(_block_to(new_block, dev))
            new_blocks.append(_block_to(new_block, host, True)
                              if host_offload else _block_to(new_block, home))
            if progress:
                print(f"[quantize] layer {li + 1}/{n_layers} (resumed)",
                      flush=True)
            continue
        if block.ln1.scale.device != dev:
            block = _block_to(block, dev)
        t0 = _clock(dev)
        # --- pass 1: accumulate tap Hessians (opt.py:131-148) ---
        H: Dict[str, torch.Tensor] = {}
        for i in range(0, N, chunk):
            accumulate(block, inps[i:i + chunk], H)
        # normalize by the number of sequences (method.py:122-123)
        H = {k: reduced(v) for k, v in H.items()}
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
        del H, quantize
        t2 = _clock(dev)
        art.times[f"layers.{li}"] = t2 - t0

        # --- pass 2: replay with quantized weights (opt.py:172-174) ---
        inps = replay_all(new_block)
        t3 = _clock(dev)
        art.phase_times[f"layers.{li}"] = (t1 - t0, t2 - t1, t3 - t2)
        if host_offload:
            new_block = _block_to(new_block, host, True)
        elif dev != home:
            new_block = _block_to(new_block, home)
        new_blocks.append(new_block)
        if resume_dir and (dp is None or dp.index == 0):
            _save_resume_layer(resume_dir, li, new_block, {
                k: v for k, v in art.errors.items()
                if k.startswith(f"layers.{li}.")})
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
        hp = M.Model(cfg, embed, [], None if params.final_ln is None
                     else params.final_ln.mapped(lambda t: t.to(dev)), None)
        Hh = None
        with f32_matmuls():
            for i in range(0, N, chunk):
                z = M.head_input(hp, inps[i:i + chunk], cfg)
                zt = z.reshape(-1, z.shape[-1]).to(torch.float32)
                up = zt.t() @ zt
                Hh = up if Hh is None else Hh + up
        Hh = reduced(Hh)
        res = _quantize_one(head.to(dev).t(), Hh, qcfg, "lm_head", seed,
                            rotations)
        head = res.W_hat.t().to(getattr(torch, cfg.dtype))
        head = _moved(head, host, True) if host_offload else head.to(home)
        record("lm_head", res, Hh)
        art.times["lm_head"] = art.linear_times["lm_head"] = \
            _clock(dev) - t0
        if progress:
            print(f"[quantize] lm_head error={art.errors['lm_head']:.4f} "
                  f"t={art.times['lm_head']:.1f}s", flush=True)

    return (M.Model(cfg, params.embed, new_blocks, params.final_ln, head),
            art)


# ---------------------------------------------------------------------------
# Resume files: quip_tpu's layer_{i}.npz
# ---------------------------------------------------------------------------


def _resume_path(resume_dir: str, li: int) -> str:
    return os.path.join(resume_dir, f"layer_{li}.npz")


def _layer_leaves(block: M.Block):
    """[(path, tensor)] of a dense Block in quip_tpu's flatten order of its
    layer tree (dict keys sorted at every level)."""
    from quip_tpu_torch.pack.model import block_tree
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, torch.Tensor):
            out.append((path, t))
        else:
            raise ValueError(f"resume files hold dense layers only; "
                             f"{'.'.join(path)} is a {type(t).__name__}")

    walk(block_tree(block), ())
    return out


def _save_resume_layer(resume_dir: str, li: int, block: M.Block,
                       errors: Dict[str, float]) -> None:
    from quip_tpu_torch.pack.format import PACK_FORMAT_VERSION
    from quip_tpu_torch.pack.model import _leaf_to_np
    arrays, dtypes = {}, []
    for i, (_, t) in enumerate(_layer_leaves(block)):
        # npz has no bf16: integer views + the dtype's name
        a, name = _leaf_to_np(t)
        arrays[f"leaf_{i}"] = a
        dtypes.append(name or "")
    np.savez(
        _resume_path(resume_dir, li),
        __format_version__=np.asarray(PACK_FORMAT_VERSION, np.int64),
        __errors__=np.asarray(list(errors.values()), np.float64),
        __error_names__=np.asarray(list(errors.keys())),
        __leaf_dtypes__=np.asarray(dtypes),
        **arrays)


def _load_resume_layer(resume_dir: str, li: int, template: M.Block):
    """(the finished Block, its errors) read against the live block's
    structure, or None when the layer has no file yet."""
    from quip_tpu_torch.pack.format import PACK_FORMAT_VERSION
    from quip_tpu_torch.pack.model import leaf_from_np
    path = _resume_path(resume_dir, li)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        ver = int(data["__format_version__"]) \
            if "__format_version__" in data.files else 1
        if ver != PACK_FORMAT_VERSION:
            raise ValueError(
                f"resume file {path} uses packed-plane layout v{ver}; this "
                f"build writes v{PACK_FORMAT_VERSION}. Delete the resume dir "
                f"and re-run the quantization.")
        n = len([k for k in data.files if k.startswith("leaf_")])
        dtypes = [str(x) for x in data["__leaf_dtypes__"]] \
            if "__leaf_dtypes__" in data.files else [""] * n
        leaves = [leaf_from_np(data[f"leaf_{i}"], dtypes[i] or None)
                  for i in range(n)]
        errors = dict(zip([str(x) for x in data["__error_names__"]],
                          [float(x) for x in data["__errors__"]]))
    want = _layer_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(f"resume file {path} holds {len(leaves)} leaves, "
                         f"the live tree expects {len(want)} — stale "
                         f"resume dir?")
    for i, (got, (_, w)) in enumerate(zip(leaves, want)):
        if tuple(got.shape) != tuple(w.shape):
            raise ValueError(
                f"resume file {path} leaf {i} has shape "
                f"{tuple(got.shape)}, the live tree expects "
                f"{tuple(w.shape)} — stale resume dir?")
    by_path = {p: t for (p, _), t in zip(want, leaves)}
    get = lambda *p: by_path.get(p)  # noqa: E731
    block = M.Block(
        M.Norm(get("ln1", "scale"), get("ln1", "bias")),
        M.Norm(get("ln2", "scale"), get("ln2", "bias")),
        M.Attention(**{k: v for k in M.Attention.NAMES
                       if (v := get("attn", k)) is not None}),
        M.MLP(**{k: v for k in M.MLP.NAMES
                 if (v := get("mlp", k)) is not None}))
    return block, errors


def save_hessians(params: M.Model, cfg: ModelConfig,
                  calib_tokens: torch.Tensor, *,
                  chunk: int = 4) -> Dict[str, torch.Tensor]:
    """Calibration only (opt_saveH.py:165-166), on the model's device:
    {linear name: H} for every linear of every block, under the un-fused
    names as quip_tpu keys them (q/k/v share one H), without quantizing."""
    N, S = calib_tokens.shape
    dev = params.embed.tokens.device
    specs = M.linear_specs(cfg)
    inps = _block_inputs(params, cfg, calib_tokens.to(dev), chunk)
    accumulate, replay = _make_block_fns(cfg, S, chunk, dev)
    out: Dict[str, torch.Tensor] = {}
    for li, block in enumerate(params.blocks):
        H: Dict[str, torch.Tensor] = {}
        for i in range(0, N, chunk):
            accumulate(block, inps[i:i + chunk], H)
        for spec in specs:
            out[f"layers.{li}.{spec.name}"] = H[spec.tap] / N
        nxt = torch.empty_like(inps)
        for i in range(0, N, chunk):
            nxt[i:i + chunk] = replay(block, inps[i:i + chunk])
        inps = nxt
    return out
