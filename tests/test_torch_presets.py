"""Every preset of models/config.py at test width, with its family shape
kept, builds and runs through the port on the CPU; its forward is held
against quip_tpu's on the same weights (1e-4 of max |logit|, f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models import get_config as jget_config
from quip_tpu.models import model as JM
from quip_tpu_torch.convert import params_from_numpy
from quip_tpu_torch.models import PRESETS, get_config
from quip_tpu_torch.models import model as TM
from quip_tpu_torch.serve import engine as TE
from tests.test_torch_families import _close, _nonzero


def _shrunk(cfg):
    """A preset at test width with its family shape kept: positions, norm,
    activation, biases, tying, post-norm, the embed projection (halved
    width) and the GQA ratio."""
    ratio = cfg.n_heads // cfg.kv_heads
    return dataclasses.replace(
        cfg, vocab_size=128, d_model=64, n_layers=1, n_heads=8,
        n_kv_heads=8 // ratio if cfg.n_kv_heads else None, d_ff=96,
        max_seq=64, embed_proj_dim=32 if cfg.embed_proj_dim else None)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_runs(preset):
    """Every preset's family shape builds with init_params, runs forward
    (held against quip_tpu on the same weights), decode_step and the paged
    engine on the CPU."""
    tcfg = _shrunk(get_config(preset))
    jcfg = _shrunk(jget_config(preset))
    tree = _nonzero(jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(2), jcfg)), np.random.default_rng(2))
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    own = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    toks = np.random.default_rng(1).integers(0, 128, (2, 9))
    _close(tparams(torch.from_numpy(toks)).numpy(),
           JM.forward(jax.tree.map(jnp.asarray, tree),
                      jnp.asarray(toks, jnp.int32), jcfg))
    assert torch.isfinite(own(torch.from_numpy(toks))).all()
    c = TM.init_caches(2, 8, tcfg, torch.float32, device="cpu")
    lg, c = TM.decode_step(own, torch.from_numpy(toks[:, :1]), c, tcfg)
    assert lg.shape == (2, 128) and c.length.tolist() == [1]
    [r] = TE.Engine(own, tcfg, max_batch=1, max_seq=32, hot=8, page=8,
                    paged=True, device="cpu").run([dict(prompt=[1, 2, 3],
                                            max_new_tokens=4)])
    assert len(r.generated) == 5
