"""Shared CLI plumbing (port of ``quip_tpu/cli/common.py``): the model,
data and quantization flags of quip_tpu's CLIs, with the port's ``--device``.

Ported: ``--weights random`` (a dense random model from a seeded
generator), checkpoints of either package (``load_checkpoint_model``, for
the CLIs' ``--load``) and the ``synthetic`` dataset. A local Hugging Face
directory waits for ``hf_import``, and the file datasets for their files
(ROADMAP queue 1 item 8); both raise.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from quip_tpu_torch import resolve_device
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as M
from quip_tpu_torch.quantize.config import PreprocConfig, QuantConfig


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("model", type=str,
                   help="model name/preset (e.g. llama-2-7b, llama-tiny)")
    p.add_argument("--weights", type=str, default=None,
                   help="'random' for a random init (the default); local "
                        "HF checkpoints are not ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; tests pass cpu)")
    p.add_argument("--dtype", type=str, default=None,
                   help="model dtype; default bfloat16 on the card, float32 "
                        "on the CPU")
    p.add_argument("--seqlen", type=int, default=None,
                   help="override model seqlen (reference README.md:14-15)")


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("dataset", type=str, nargs="?", default="c4",
                   choices=["wikitext2", "ptb", "ptb-new", "c4", "c4-new",
                            "synthetic"],
                   help="calibration dataset (datautils.py:180-190); only "
                        "'synthetic' is in the repository")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)


def add_quant_args(p: argparse.ArgumentParser):
    """Mirror of the reference quantization flags (opt.py:489-589)."""
    p.add_argument("--wbits", type=int, default=16,
                   choices=[2, 3, 4, 8, 16])
    p.add_argument("--quant", type=str, default="nearest",
                   choices=["allbal", "ldlq", "ldlqRG", "ldlbal_admm",
                            "nearest", "gptq", "trueobs"])
    p.add_argument("--npasses", type=int, default=0)
    p.add_argument("--unbiased", action="store_true")
    p.add_argument("--qfn", type=str, default="a", choices=["a", "b"])
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--pre_gptqH", action="store_true")
    p.add_argument("--pre_rescale", action="store_true")
    p.add_argument("--pre_proj", action="store_true")
    p.add_argument("--pre_proj_extra", type=int, default=1,
                   choices=[0, 1, 2],
                   help="butterfly mode: 0=block 1=noblock 2=nopermute "
                        "(method.py:125-135); overridden by --proj_mode")
    p.add_argument("--proj_mode", type=str, default=None,
                   choices=["block", "noblock", "nopermute", "rht", "rht_sf",
                            "rht_uf"],
                   help="rotation kind; 'rht' (default for "
                        "--incoh_processing) is the permutation-free "
                        "transform")
    p.add_argument("--incoh_processing", action="store_true",
                   help="meta-flag: pre_gptqH+pre_rescale+pre_proj+qfn=b "
                        "(opt.py:592-597)")
    p.add_argument("--lazy_batch", action="store_true",
                   help="(always on: the solvers are blocked; kept for CLI "
                        "parity)")
    p.add_argument("--quant_head", action="store_true",
                   help="also quantize the (untied) lm_head; no reference "
                        "counterpart")


def quant_config_from_args(args) -> QuantConfig:
    if args.incoh_processing:
        kw = {}
        if args.proj_mode:
            kw["proj_mode"] = args.proj_mode
        return QuantConfig.incoherence(
            wbits=args.wbits, method=args.quant, npasses=args.npasses,
            unbiased=args.unbiased, **kw)
    mode = args.proj_mode or \
        {0: "block", 1: "noblock", 2: "nopermute"}[args.pre_proj_extra]
    return QuantConfig(
        wbits=args.wbits, method=args.quant, npasses=args.npasses,
        unbiased=args.unbiased, qfn=args.qfn, groupsize=args.groupsize,
        preproc=PreprocConfig(
            rescale=args.pre_rescale, proj=args.pre_proj,
            proj_mode=mode, gptqH=args.pre_gptqH,
            percdamp=args.percdamp),
        seed=args.seed)


def model_config(args):
    """(cfg, device) from the CLI's model flags: the preset with
    ``--seqlen`` and ``--dtype`` (default bfloat16 on the card, float32 on
    the CPU) applied; draws no weights."""
    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.seqlen:
        cfg = replace(cfg, max_seq=args.seqlen)
    if args.dtype is None:
        args.dtype = "bfloat16" if dev.type == "cuda" else "float32"
    return replace(cfg, dtype=args.dtype), dev


def load_model(args):
    """(Model, cfg) from the CLI's model flags, on ``--device``: a random
    model drawn from a generator on that device seeded with ``--seed``."""
    if args.weights and args.weights != "random":
        raise NotImplementedError(
            f"--weights {args.weights!r}: loading Hugging Face checkpoints "
            f"(models/hf_import.py) is not ported yet (ROADMAP queue 1 "
            f"item 8); use --weights random")
    cfg, dev = model_config(args)
    gen = torch.Generator(device=dev).manual_seed(getattr(args, "seed", 0))
    return M.init_params(gen, cfg, device=dev), cfg


def load_checkpoint_model(args):
    """(Model, cfg, meta) from the checkpoint at ``--load`` (written by
    either package), on ``--device``; cfg as ``model_config`` gives it,
    with no random model drawn first. Leaves keep their stored dtypes."""
    from quip_tpu_torch.convert import params_from_numpy
    from quip_tpu_torch.pack.model import load_checkpoint
    cfg, dev = model_config(args)
    tree, meta = load_checkpoint(args.load)
    return params_from_numpy(tree, cfg, device=dev), cfg, meta


def get_data(args, cfg):
    from quip_tpu_torch.data.calib import get_loaders
    seqlen = args.seqlen or min(cfg.max_seq, 2048)
    return get_loaders(args.dataset, nsamples=args.nsamples, seed=args.seed,
                       seqlen=seqlen, model=args.model,
                       vocab_size=cfg.vocab_size), seqlen
