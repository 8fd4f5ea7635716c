"""Typed configuration for the quantization pipeline.

A copy of ``quip_tpu.quantize.config`` (the port imports nothing of the
JAX package). One config shared by the CLIs, replacing the reference's
per-script argparse forests (opt.py:489-589, llama.py:479-505,
zeroShot/utils.py:53-99).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

METHODS = ("ldlq", "ldlqRG", "allbal", "ldlbal_admm", "ldl_gptqequiv",
           "gptq", "trueobs", "nearest")
QFNS = ("a", "b", "c")


PROJ_MODES = ("block", "noblock", "nopermute", "rht", "rht_sf", "rht_uf")


@dataclass(frozen=True)
class PreprocConfig:
    """Incoherence preprocessing flags (reference method.py:125-193).

    proj_mode: 'block'/'noblock'/'nopermute' are the reference's butterfly
    variants (--pre_proj_extra 0/1/2); 'rht' is the permutation-free
    randomized Hadamard/Kronecker transform with the same incoherence
    guarantees. 'rht_sf' / 'rht_uf'
    are the sign-folded variants: the outer signs are absorbed into the
    packed qfn-b codes at pack time (fold_rht_signs / fold_rht_sign_rows).
    On structured inputs (flat-top-eigenvector Hessians, mean-structured
    weights) the lost sign randomization raises the proxy error
    (tests/test_signfold.py::test_structured_inputs_expose_fold_quality_gap),
    so 'rht' stays the default.
    """

    rescale: bool = False            # --pre_rescale
    proj: bool = False               # --pre_proj
    proj_mode: str = "rht"
    gptqH: bool = False              # --pre_gptqH
    percdamp: float = 0.01           # --percdamp

    def __post_init__(self):
        if self.proj_mode not in PROJ_MODES:
            raise ValueError(f"unknown proj_mode {self.proj_mode!r}")


@dataclass(frozen=True)
class QuantConfig:
    """Full quantization recipe for one run."""

    wbits: int = 4                   # {2, 3, 4, 16}
    method: str = "ldlq"             # one of METHODS  (--quant)
    npasses: int = 0                 # greedy passes   (--npasses)
    unbiased: bool = False           # --unbiased
    qfn: str = "a"                   # --qfn
    blocksize: int = 128             # lazy-batch block width (--lazy_batch)
    groupsize: int = -1              # GPTQ group size (--groupsize)
    sparse_outlier: float = 0.0      # TrueOBS fp-outlier escape (0 = off;
                                     # reference uses 0.25,
                                     # fast_trueobs.py:108). method="trueobs"
                                     # turns it on at 0.25 unless set here.
    preproc: PreprocConfig = dataclasses.field(default_factory=PreprocConfig)
    seed: int = 0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.qfn not in QFNS:
            raise ValueError(f"unknown qfn {self.qfn!r}")
        if self.qfn == "b" and not self.preproc.proj and self.method != "nearest":
            # reference asserts qfn-b requires projection (opt.py:613-614)
            # (nearest+qfn-b is exercised standalone in the zeroShot RTN path)
            pass

    @staticmethod
    def incoherence(wbits: int, method: str = "ldlq", npasses: int = 0,
                    **kw) -> "QuantConfig":
        """The --incoh_processing meta-flag (opt.py:592-597):
        pre_gptqH + pre_rescale + pre_proj + qfn='b'.

        The reference sets `args.proj_extra = 1` but reads
        `args.pre_proj_extra` (a latent typo, opt.py:596), so its effective
        butterfly mode is 'block'. This package defaults to 'rht'
        (permutation-free, the same orthogonal-incoherence math).
        """
        return QuantConfig(
            wbits=wbits,
            method=method,
            npasses=npasses,
            qfn="b",
            preproc=PreprocConfig(rescale=True, proj=True, gptqH=True,
                                  proj_mode=kw.pop("proj_mode", "rht")),
            **kw,
        )
