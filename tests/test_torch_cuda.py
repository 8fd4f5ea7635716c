"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they skip without a card (a CUDA kernel has no CPU mode).
The card's machine has no jax, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither jax nor quip_tpu. Tolerances: K1 on f32 inputs
holding bf16 values differs from the plain version only in summation order
(1e-3 of max |y|); K2 feeds bf16 softmax weights to its PV product (2e-2).
"""
import math

import pytest
import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.kernels import flash_attn as FA
from quip_tpu_torch.pack.format import PLANE_SPLITS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bits,qfn,code_bits", [
    (2, "b", None), (3, "b", None), (4, "b", None), (8, "b", None),
    (4, "b", 3), (2, "a", None)])
@pytest.mark.parametrize("B", [1, 3, 40])
def test_k1_matches_plain(cuda, bits, qfn, code_bits, B):
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + B)
    m, d = 384, 512
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[bits])
    if code_bits:
        planes = tuple(p & 0x77777777 for p in planes)
    scale, zero = torch.tensor(0.03, device=cuda), None
    if qfn == "a":
        scale = torch.rand(m, generator=g, device=cuda) * 0.05 + 0.01
        zero = torch.rand(m, generator=g, device=cuda) * 4
    x = torch.randn(B, d, generator=g, device=cuda).bfloat16().float()
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    before = DM.launches
    got = DM.dequant_matmul(x, planes, scale, zero, **kw)
    assert DM.launches == before + 1
    want = DM.dequant_matmul_ref(x, planes, scale, zero, **kw)
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-3


@pytest.mark.parametrize("B,H,KV,S,plen", [(2, 8, 8, 300, [300, 131]),
                                           (1, 8, 2, 77, [77])])
def test_k2_matches_plain(cuda, B, H, KV, S, plen):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, S, H, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(B, S, KV, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(B, S, KV, 128, generator=g, device=cuda).bfloat16()
    pl = torch.tensor(plen, dtype=torch.int32, device=cuda)
    before = FA.launches
    got = FA.flash_prefill_bshd(q, k, v, pl, scale=1 / math.sqrt(128))
    assert FA.launches == before + 1
    want = FA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                scale=1 / math.sqrt(128))
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.randn(2, 64, device=cuda)
    plane = torch.zeros(4, 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        DM.dequant_matmul(x, (plane.t().contiguous(),), 1.0, None, bits=2)
    q = torch.randn(1, 8, 2, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        FA.flash_prefill_bshd(q, q, q, None, scale=1.0)
