"""The plain reference: float32 forwards of OPT and BLOOM in plain PyTorch
(TF32 off), decoding the 2-bit planes and the RHT rotations from the raw
tensors by a frozen copy of their arithmetic. Imports torch, numpy and
math only: nothing of ``quip_tpu_torch``, ``quip_tpu`` or ``jax``."""
