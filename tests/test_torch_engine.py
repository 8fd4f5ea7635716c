"""Port parity for the serving engine: greedy tokens equal quip_tpu's paged
Engine through queueing, retire, re-admission, the max_new_tokens clamp
and hot-ring flushes; sampling filters equal quip_tpu's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.serve import engine as JE
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_model import _both


def test_engine_greedy_tokens_equal():
    jcfg, jparams, tcfg, tparams = _both(seed=2)
    rng = np.random.default_rng(2)
    V = jcfg.vocab_size
    # 3 requests through 2 slots (one queues); the second asks for more
    # than the sequence holds and is clamped to max_seq - 1 - 20 = 43
    reqs = [dict(prompt=rng.integers(0, V, 5).tolist(), max_new_tokens=12),
            dict(prompt=rng.integers(0, V, 20).tolist(), max_new_tokens=100),
            dict(prompt=rng.integers(0, V, 3).tolist(), max_new_tokens=9)]
    je = JE.Engine(jparams, jcfg, max_batch=2, max_seq=64, paged=True,
                   hot=8, page=8)
    want = [r.generated for r in je.run(reqs)]
    te = TE.Engine(tparams, tcfg, max_batch=2, max_seq=64, hot=8, page=8,
                   device="cpu")
    got = [r.generated for r in te.run(reqs)]
    assert [len(g) for g in got] == [13, 44, 10]
    assert got == want
    st = te.stats()
    assert st["completed"] == 3 and st["tokens"] == 67 and st["queued"] == 0


@pytest.mark.parametrize("top_k,top_p", [(5, None), (0, [0.9, 0.5, 1.0]),
                                         (7, [0.8, 1.0, 0.3])])
def test_filtered_logits_matches(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    temps = np.array([0.7, 1.0, 1.5], np.float32)
    want = np.asarray(JE._filtered_logits(
        jnp.asarray(logits), jnp.asarray(temps), top_k,
        None if top_p is None else jnp.asarray(top_p, jnp.float32)))
    got = TE._filtered_logits(torch.from_numpy(logits), temps, top_k,
                              top_p).numpy()
    np.testing.assert_array_equal(got <= np.finfo(np.float32).min,
                                  want <= np.finfo(np.float32).min)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sample_greedy_and_seeded():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 30)).astype(np.float32))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = TE._sample(g1, logits, [0.0, 1.0], top_k=4)
    b = TE._sample(g2, logits, [0.0, 1.0], top_k=4)
    assert a.tolist() == b.tolist()           # same seed, same draw
    assert int(a[0]) == int(logits[0].argmax())
    assert int(a[1]) in logits[1].topk(4).indices.tolist()


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    _, _, tcfg, tparams = _both()
    with pytest.raises(RuntimeError, match="cuda"):
        TE.Engine(tparams, tcfg)
    assert jax.devices()[0].platform == "cpu"
