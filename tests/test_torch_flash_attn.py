"""Port parity for K2's plain version: quip_tpu's Pallas flash prefill in
interpret mode vs the port's flash_prefill_bshd on the CPU (its plain
version), at B = 2 with plen < S, GQA, and S not a multiple of 256.
Tolerance 2e-2: the Pallas kernel feeds bf16 operands (and bf16 softmax
weights) to its dots, the plain version is f32 throughout."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.kernels.flash_attn import flash_prefill_bshd as j_flash
from quip_tpu_torch.kernels import flash_attn as TFA


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_plain_matches_pallas(kv_heads):
    rng = np.random.default_rng(kv_heads)
    B, S, H, hd = 2, 300, 4, 128
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv_heads, hd)).astype(np.float32)
    plen = np.array([S, 177], np.int32)
    scale = 1.0 / math.sqrt(hd)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(plen), scale=scale,
                              interpret=True), np.float32)
    before = TFA.launches
    got = TFA.flash_prefill_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(plen),
                                 scale=scale).numpy()
    assert TFA.launches == before       # the CPU path launches no kernel
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
