"""Port parity for K2's plain version: quip_tpu's Pallas flash prefill in
interpret mode vs the port's flash_prefill_bshd on the CPU (its plain
version), at B = 2 with plen < S, GQA, and S not a multiple of 256.
Tolerance 2e-2: the Pallas kernel feeds bf16 operands (and bf16 softmax
weights) to its dots, the plain version is f32 throughout. The same limit
holds ``flash_prefill_tiled_ref`` (the CUDA kernel's arithmetic in plain
PyTorch: key tiles of the kernel's 128 keys, base-2 online softmax, bf16
weights into PV) against the plain version and against the Pallas kernel:
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


@pytest.mark.parametrize("tk", [64, 128, 176])
@pytest.mark.parametrize("S,H,KV,plen", [
    (129, 2, 2, [129, 128]),      # one key past a 128-key tile; plen = TK
    (257, 8, 1, [257, 130]),      # GQA 8:1, plen just past a tile
    (255, 4, 2, [1, 255])])       # a row of plen 1, S one short of 2 tiles
def test_flash_tiled_key_tiles_match_plain(tk, S, H, KV, plen):
    """The kernel's arithmetic at its key tile (128) and the widths
    tools/tune_flash.py sweeps (64, 176), at the tile edges."""
    rng = np.random.default_rng(S + tk)
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(rng, 2, S, H, KV))
    pl = torch.tensor(plen, dtype=torch.int32)
    scale = 1.0 / math.sqrt(128)
    got = TFA.flash_prefill_tiled_ref(q, k, v, pl, scale=scale, tk=tk)
    want = TFA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                 scale=scale)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_flash_tiled_matches_pallas():
    """The kernel's arithmetic (key tiles of 128) against quip_tpu's Pallas
    kernel in interpret mode, GQA 2:1 with plen < S."""
    assert TFA.KEY_TILE == 128
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 300, 4, 2)
    pl = np.array([300, 140], np.int32)
    scale = 1.0 / math.sqrt(128)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pl), scale=scale, interpret=True),
                      np.float32)
    got = TFA.flash_prefill_tiled_ref(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
        torch.from_numpy(pl), scale=scale).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_aligned_copies_only_an_unaligned_view():
    """The wrapper hands the kernel's tensor maps 16-byte aligned
    addresses: a contiguous view at an odd offset is copied, an aligned
    tensor is passed as it is."""
    base = torch.randn(1 + 2 * 8 * 128).bfloat16()
    odd = base[1:].view(1, 2, 8, 128)
    assert odd.data_ptr() % 16 != 0
    fixed = TFA._aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    even = torch.randn(1, 2, 8, 128).bfloat16()
    assert TFA._aligned(even) is even


@pytest.mark.parametrize("hd,want", [(128, True), (256, False), (64, False)])
def test_flash_gate_admits_only_the_kernels_head_width(hd, want, monkeypatch):
    """K2 takes hd = 128 only: the gate refuses every other width (quip_tpu's
    admits any multiple of 128), which then takes dense attention, the
    same function; the CUDA tensor is a stand-in with ``is_cuda``."""
    import dataclasses
    import types

    from quip_tpu_torch.models import model as TM
    from quip_tpu_torch.models.config import get_config
    monkeypatch.delenv("QUIP_FLASH_PREFILL", raising=False)
    cfg = dataclasses.replace(get_config("llama-2-7b"), head_dim=hd)
    assert cfg.hd == hd
    x = types.SimpleNamespace(is_cuda=True)
    plen = torch.tensor([600], dtype=torch.int32)
    assert TM._flash_eligible(cfg, 600, x, plen) is want
