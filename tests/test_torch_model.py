"""Port parity for the model and the paged cache on llama-tiny, 2-bit
packed (random codes, real RHT rotations), carried over from quip_tpu by
params_from_numpy. All f32 on the CPU: tolerance 1e-4 (summation order)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu.models import paged as JP
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.models import paged as TP

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_packed_llama(cfg, bits=2, seed=0):
    """quip_tpu's random-code packed Llama (the bench model), f32."""
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from __graft_entry__ import _packed_llama
    return _packed_llama(cfg, bits=bits, seed=seed, dtype=jnp.float32,
                         head_bits=bits)


def _both(name="llama-tiny", kv_heads=None, seed=0):
    jcfg = jget_config(name)
    tcfg = get_config(name)
    if kv_heads:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=kv_heads)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=kv_heads)
    jparams = _jax_packed_llama(jcfg, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("packed", [True, False])
def test_forward_matches(packed):
    """Packed (fused wqkv / wgu) and dense (unfused) parameter trees."""
    if packed:
        jcfg, jparams, tcfg, tparams = _both()
    else:
        jcfg, tcfg = jget_config("llama-tiny"), get_config("llama-tiny")
        jparams = JM.init_params(jax.random.key(4), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(JM.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                 jcfg))
    got = tparams(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _jax_chain(params, cfg, prompts, plens, steps, cap, hot, page):
    B = len(prompts)
    caches = JP.init_paged(B, cap, cfg, dtype=jnp.float32, hot=hot,
                           page=page)
    out = []
    for slot, (pr, n) in enumerate(zip(prompts, plens)):
        lg, caches = JP.paged_prefill_slot(
            params, jnp.asarray(pr, jnp.int32)[None], jnp.asarray(n),
            caches, jnp.asarray(slot), cfg)
        out.append(np.asarray(lg))
    misc, layers = JP.split_blocks(params)
    step = jax.jit(lambda m, l, t, c: JP.paged_decode_step_unrolled(
        m, l, t, c, cfg, page=page))
    flush = jax.jit(JP.flush_hot)
    for t in steps:
        lg, hot_s = step(misc, layers, jnp.asarray(t, jnp.int32)[:, None],
                         caches)
        caches = JP.advance(caches, hot_s)
        if int(np.max(np.asarray(caches.hot_len))) >= hot:
            caches = flush(caches)
        out.append(np.asarray(lg))
    return out


def _port_chain(params, cfg, prompts, plens, steps, cap, hot, page):
    B = len(prompts)
    caches = TP.init_paged(B, cap, cfg, dtype=torch.float32, hot=hot,
                           page=page, device="cpu")
    out = []
    for slot, (pr, n) in enumerate(zip(prompts, plens)):
        lg, caches = TP.paged_prefill_slot(
            params, torch.as_tensor(pr)[None], n, caches, slot, cfg)
        out.append(lg.numpy())
    for t in steps:
        lg, hot_s = TP.paged_decode_step(params, torch.as_tensor(t)[:, None],
                                         caches, cfg, page=page)
        caches = TP.advance(caches, hot_s)
        if int(caches.hot_len.max()) >= hot:
            caches = TP.flush_hot(caches)
        out.append(lg.numpy())
    return out


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_paged_prefill_decode_matches(kv_heads):
    """Teacher-forced paged prefill (one padded prompt) + 20 decode steps
    across two hot-ring flushes (hot = 8), MHA and GQA."""
    jcfg, jparams, tcfg, tparams = _both(kv_heads=kv_heads, seed=1)
    rng = np.random.default_rng(1)
    V = jcfg.vocab_size
    prompts = [rng.integers(0, V, 9), rng.integers(0, V, 16)]
    plens = [9, 11]                 # slot 1: right-padded prompt
    steps = [rng.integers(0, V, 2) for _ in range(20)]
    want = _jax_chain(jparams, jcfg, prompts, plens, steps, 48, 8, 8)
    got = _port_chain(tparams, tcfg, prompts, plens, steps, 48, 8, 8)
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["opt-tiny", "bloom-tiny"])
def test_other_families_raise(name):
    with pytest.raises(NotImplementedError, match="OPT/BLOOM"):
        TM.Model(get_config(name), torch.zeros(4, 4), [], torch.ones(4))


@pytest.mark.parametrize("module,name", [(TP, "init_paged"),
                                         (TM, "init_caches")])
def test_cache_constructors_default_to_the_card(module, name):
    """The cache constructors are entry points: their device defaults to
    "cuda" and, with no card, the default raises instead of allocating on
    the CPU; device="cpu" still gives a CPU cache."""
    import inspect
    fn = getattr(module, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = get_config("llama-tiny")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(1, 64, cfg)
    cache = fn(1, 64, cfg, device="cpu")
    assert cache.k.device.type == "cpu"
