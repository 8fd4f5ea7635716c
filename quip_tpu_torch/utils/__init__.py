"""Shared small utilities (port of ``quip_tpu/utils/__init__.py``)."""
import contextlib
import zlib

import torch


def name_salt(name: str) -> int:
    """Deterministic 31-bit salt for deriving per-layer random streams from
    names. Python's built-in hash() is randomized per process
    (PYTHONHASHSEED), which would make quantization non-reproducible
    across runs; crc32 is stable everywhere."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


@contextlib.contextmanager
def f32_matmuls():
    """True float32 matmuls inside the block (TF32 off on the card), the
    caller's settings restored after it. The quantizer's Cholesky and error
    recurrences, and the Hessians they factor, need real f32: TF32's
    10-bit mantissa corrupts H enough to break the Cholesky."""
    old_prec = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old_prec)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
