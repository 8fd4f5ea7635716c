"""Port parity for K2's plain version: quip_tpu's Pallas flash prefill in
interpret mode vs the port's flash_prefill_bshd on the CPU (its plain
version), at B = 2 with plen < S, GQA, and S not a multiple of 256.
Tolerance 2e-2: the Pallas kernel feeds bf16 operands (and bf16 softmax
weights) to its dots, the plain version is f32 throughout. The same limit
holds ``flash_prefill_tiled_ref`` (the CUDA kernel's arithmetic in plain
PyTorch: key tiles of 64, bf16 weights into PV) against the plain version:
the CPU witness of the card test's tolerance."""
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


def _qkv(rng, B, S, H, KV, hd=128):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("S,H,KV,plen", [
    (200, 4, 4, [200, 1]),        # S not a multiple of 64, a row of plen 1
    (130, 8, 2, [77, 130]),       # GQA 4:1, plen < S in the first row
])
def test_flash_plain_matches_pallas_edges(S, H, KV, plen):
    rng = np.random.default_rng(S)
    q, k, v = _qkv(rng, 2, S, H, KV)
    pl = np.array(plen, np.int32)
    scale = 1.0 / math.sqrt(128)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pl), scale=scale, interpret=True),
                      np.float32)
    got = TFA.flash_prefill_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(pl),
                                 scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S,H,KV,plen", [
    (200, 4, 4, [200, 1]), (130, 8, 2, [77, 130]), (64, 2, 1, [64, 64]),
    (257, 2, 2, [257, 129])])
def test_flash_tiled_bf16_p_matches_plain(S, H, KV, plen):
    rng = np.random.default_rng(S + 1)
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(rng, 2, S, H, KV))
    pl = torch.tensor(plen, dtype=torch.int32)
    scale = 1.0 / math.sqrt(128)
    got = TFA.flash_prefill_tiled_ref(q, k, v, pl, scale=scale)
    want = TFA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                 scale=scale)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= 2e-2
    none = TFA.flash_prefill_tiled_ref(q, k, v, None, scale=scale)
    full = TFA.flash_prefill_ref(q.float(), k.float(), v.float(), None,
                                 scale=scale)
    assert (none.float() - full).abs().max().item() <= 2e-2


@pytest.mark.parametrize("env,want", [(None, True), ("1", True), ("0", False)])
def test_flash_gate_reads_quip_flash_prefill(env, want, monkeypatch):
    """QUIP_FLASH_PREFILL (read at call time, default on) turns the flash
    prefill off when it is not "1", as quip_tpu's gate does
    (models/model.py); every other condition of the gate holds here, the
    CUDA tensor being a stand-in with ``is_cuda``."""
    import types

    from quip_tpu_torch.models import model as TM
    from quip_tpu_torch.models.config import get_config
    if env is None:
        monkeypatch.delenv("QUIP_FLASH_PREFILL", raising=False)
    else:
        monkeypatch.setenv("QUIP_FLASH_PREFILL", env)
    x = types.SimpleNamespace(is_cuda=True)
    plen = torch.tensor([600], dtype=torch.int32)
    assert TM._flash_eligible(get_config("llama-2-7b"), 600, x, plen) is want
