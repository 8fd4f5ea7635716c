"""quip_tpu_torch: the PyTorch/CUDA port of quip_tpu.

Quantizes OPT, Llama and BLOOM models with QuIP (calibration, incoherence
processing, LDLQ / OPTQ rounding, packing, checkpoints: ``quantize/``,
``core/``, ``pack/``, ``cli/quantize.py``) and serves the packed models on an NVIDIA
H100 through hand-written CUDA kernels (``kernels/csrc``): the packed
dequant-matmul, the flash prefill, the fused RHT application and the
slab-dot variant of the dequant-matmul that the kernel microbenchmark
(``tools/bench_kernel.py``) sweeps. ``quip_tpu`` (JAX) stays the
reference; this package never imports it or jax.

Entry points take ``device=`` and default to ``"cuda"``: with no card the
default raises instead of running on the CPU. Tests pass ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "quip_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (a CUDA device without an
    index is the current one)."""
    def canon(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return canon(a) == canon(b)
