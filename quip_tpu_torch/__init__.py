"""quip_tpu_torch: the PyTorch/CUDA port of quip_tpu (serving slice).

Serves QuIP-packed Llama models on an NVIDIA H100 through hand-written
CUDA kernels (``kernels/csrc``) for the packed dequant-matmul and the
flash prefill. ``quip_tpu`` (JAX) stays the reference; this package never
imports it or jax.

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
