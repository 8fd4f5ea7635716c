"""Port parity: packed planes, padded_m and model presets
(quip_tpu_torch vs quip_tpu on the same numpy-seeded inputs).

Integer layout must match bit for bit; configs field for field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.models.config import PRESETS as JPRESETS
from quip_tpu.models.config import get_config as jget_config
from quip_tpu.pack import format as JF
from quip_tpu_torch.models.config import PRESETS, get_config
from quip_tpu_torch.pack import format as TF


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_planes_bit_identical(bits):
    rng = np.random.default_rng(bits)
    m, d = 48, 256
    codes = rng.integers(0, 2 ** bits, (m, d)).astype(np.int32)
    want = JF.pack_codes(jnp.asarray(codes, jnp.int32), bits)
    got = TF.pack_codes(torch.from_numpy(codes), bits)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = TF.unpack_codes(got, bits, d)
    np.testing.assert_array_equal(back.numpy(), codes)
    # the JAX unpacker reads the port's planes the same way
    np.testing.assert_array_equal(
        np.asarray(JF.unpack_codes(tuple(jnp.asarray(g.numpy())
                                         for g in got), bits, d)), codes)


@pytest.mark.parametrize("m,d", [(12288, 4096), (4096, 4096), (22016, 4096),
                                 (4096, 11008), (32000, 4096)])
def test_padded_m_matches(m, d):
    for bits in (2, 3, 4):
        assert TF.padded_m(m, d, bits) == JF.padded_m(m, d, bits)
    assert TF.padded_m(22016, 4096, 2) == 22528


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_presets_match(name):
    assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(
        JPRESETS[name])
    assert get_config(name) == PRESETS[name]
    assert get_config(f"meta-llama/{name}").hd == jget_config(name).hd
