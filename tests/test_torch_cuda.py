"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they skip without a card (a CUDA kernel has no CPU mode).
The card's machine has no jax, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither jax nor quip_tpu. Tolerances: K1-decode and
K1-tile on f32 inputs holding bf16 values differ from the plain version only
in summation order (1e-3 of max |y|; 1e-2 with bf16 outputs, their rounding);
K2 feeds bf16 softmax weights to its PV product (2e-2);
K3 rounds as its plain version does and differs in summation order (2e-5
in f32, 2e-2 in bf16: one bf16 rounding per product); K1′ against its
plain version 1e-3, against K1 2e-2 (its 128·Σx fix-up in f32).
"""
import math

import numpy as np
import pytest
import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.core import incoherence as inc
from quip_tpu_torch.kernels import flash_attn as FA
from quip_tpu_torch.kernels import rht as K3
from quip_tpu_torch.kernels import slabdot as SD
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


@pytest.mark.parametrize("bits,qfn,code_bits", [
    (2, "b", None), (3, "b", None), (4, "b", None), (8, "b", None),
    (4, "b", 3), (2, "a", None), (4, "a", None)])
@pytest.mark.parametrize("B", [9, 17, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_tile_matches_plain(cuda, bits, qfn, code_bits, B, dtype):
    """The tensor-core path: m = 328 leaves a ragged warp of columns,
    d = 1408 a ragged group of word rows in the 1-bit plane of 3-bit."""
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + B)
    m, d = 328, 1408
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[bits])
    if code_bits:
        planes = tuple(p & 0x77777777 for p in planes)
    scale, zero = torch.tensor(0.03, device=cuda), None
    if qfn == "a":
        scale = torch.rand(m, generator=g, device=cuda) * 0.05 + 0.01
        zero = torch.rand(m, generator=g, device=cuda) * 4
    x = torch.randn(B, d, generator=g, device=cuda).bfloat16()
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    before = DM.launches, DM.launches_tile
    got = DM.dequant_matmul(x.to(dtype), planes, scale, zero, **kw)
    assert (DM.launches, DM.launches_tile) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    want = DM.dequant_matmul_ref(x.float(), planes, scale, zero, **kw)
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() <= (1e-3 if dtype == torch.float32 else 1e-2)
    # and the decode kernel on the first 8 of the same rows
    d0 = DM.launches_decode
    old = DM.dequant_matmul(x.float()[:8], planes, scale, zero, **kw)
    assert DM.launches_tile == before[1] + 1
    assert DM.launches_decode == d0 + 1
    assert ((old - want[:8]).abs().max() / want.abs().max()).item() <= 1e-3


def _k1_case(cuda, bits, qfn, code_bits, m, d, B, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[bits])
    if code_bits:
        planes = tuple(p & 0x77777777 for p in planes)
    scale, zero = torch.tensor(0.03, device=cuda), None
    if qfn == "a":
        scale = torch.rand(m, generator=g, device=cuda) * 0.05 + 0.01
        zero = torch.rand(m, generator=g, device=cuda) * 4
    x = torch.randn(B, d, generator=g, device=cuda).bfloat16()
    return x, planes, scale, zero


@pytest.mark.parametrize("bits,qfn,code_bits", [
    (2, "b", None), (3, "b", None), (4, "b", None), (8, "b", None),
    (4, "b", 3), (2, "a", None), (4, "a", None)])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_decode_matches_plain(cuda, bits, qfn, code_bits, B, dtype):
    """The decode path at a ragged shape, as dispatched and with every
    ``path=``: one launch of K1-decode (or of K1-tile when forced)."""
    m, d = 328, 1408
    x, planes, scale, zero = _k1_case(cuda, bits, qfn, code_bits, m, d, B,
                                      bits * 100 + B)
    kw = dict(bits=bits, qfn=qfn, code_bits=code_bits)
    want = DM.dequant_matmul_ref(x.float(), planes, scale, zero, **kw)
    for path in (None, "decode", "tile"):
        before = DM.launches, DM.launches_decode, DM.launches_tile
        got = DM.dequant_matmul(x.to(dtype), planes, scale, zero, path=path,
                                **kw)
        tile = int(path == "tile")
        assert (DM.launches, DM.launches_decode, DM.launches_tile) == (
            before[0] + 1, before[1] + 1 - tile, before[2] + tile)
        assert got.dtype == dtype
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err.item() <= (1e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_k1_decode_takes_any_shape(cuda, bits, B):
    """m no multiple of 4 (words loaded one by one) and d·f no multiple of
    64 (x staged pair by pair); 20 rows go 8 at a time."""
    m, d = 330, 96
    x, planes, scale, zero = _k1_case(cuda, bits, "b", None, m, d, B,
                                      bits * 10 + B)
    before = DM.launches_decode
    got = DM.dequant_matmul(x.float(), planes, scale, zero, bits=bits)
    assert DM.launches_decode == before + -(-B // 8)
    want = DM.dequant_matmul_ref(x.float(), planes, scale, zero, bits=bits)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3


def test_k1_decode_is_reproducible(cuda):
    """The splits add in a fixed order: two launches give the same bits."""
    x, planes, scale, zero = _k1_case(cuda, 2, "b", None, 4096, 4096, 3, 0)
    a = DM.dequant_matmul(x, planes, scale, zero, bits=2)
    b = DM.dequant_matmul(x, planes, scale, zero, bits=2)
    assert torch.equal(a, b)


def test_k1_dispatch_by_shape(cuda):
    """A shape K1-tile does not take goes to K1-decode at any B, 8 rows at
    a time; forcing the tile path on it raises."""
    g = torch.Generator(device=cuda).manual_seed(0)
    m, d = 100, 96                       # m % 8 != 0, d * f % 128 != 0
    plane = torch.randint(-2 ** 31, 2 ** 31, (d * 2 // 32, m),
                          dtype=torch.int32, generator=g, device=cuda)
    x = torch.randn(40, d, generator=g, device=cuda).bfloat16().float()
    before = DM.launches_tile, DM.launches_decode
    got = DM.dequant_matmul(x, (plane,), 0.03, None, bits=2)
    assert (DM.launches_tile, DM.launches_decode) == (before[0],
                                                      before[1] + 5)
    want = DM.dequant_matmul_ref(x, (plane,), torch.tensor(0.03, device=cuda),
                                 None, bits=2)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    with pytest.raises(ValueError):
        DM.dequant_matmul(x, (plane,), 0.03, None, bits=2, path="tile")
    with pytest.raises(ValueError):
        DM.dequant_matmul(x, (plane,), 0.03, None, bits=2, path="partial")


@pytest.mark.parametrize("B,H,KV,S,plen", [(2, 8, 8, 300, [300, 131]),
                                           (1, 8, 2, 77, [77]),
                                           (2, 8, 8, 513, [513, 1]),
                                           (1, 8, 2, 2048, [2048]),
                                           (2, 4, 1, 64, [64, 63])])
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


@pytest.mark.parametrize("n", [64, 96, 352, 1376, 2 * 250, 8])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, n, transpose, dtype):
    """pow2 x pow2, pow2 x dense orthogonal (12, 11, 43 and 125 columns:
    ragged 32-column blocks; a = 4 rows), and n = 8 without a right
    factor."""
    rots = torch.Generator().manual_seed(n)
    g = torch.Generator(device=cuda).manual_seed(n)
    t = inc.gen_rht(rots, n, device=cuda)
    if n == 8:
        t = inc.RHT(t.signs, inc._hadamard(3, device=cuda), None, 8)
    vec = t.signs / (torch.rand(n, generator=g, device=cuda) + 0.5)
    x = torch.randn(7, n, generator=g, device=cuda).to(dtype)
    before = K3.launches
    got = K3.rht_apply_fused(x, vec, t.left, t.right, transpose=transpose)
    assert K3.launches == before + 1 and got.dtype == dtype
    want = K3.rht_apply_fused_ref(x, vec, t.left, t.right,
                                  transpose=transpose)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= (2e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("n,a,b", [(4096, 64, 64), (11008, 128, 86),
                                   (12288, 128, 96), (22016, 128, 172),
                                   (32000, 128, 250), (64, 64, 1)])
@pytest.mark.parametrize("B", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_path_shapes(cuda, n, a, b, B, dtype):
    """The five Llama-2-7B splits of the serving path and a right-factor-
    free case, both directions, and forward-then-transpose against x (f32:
    1e-5; bf16: the two roundings, 4e-2 of max |x|)."""
    rots = torch.Generator().manual_seed(n)
    g = torch.Generator(device=cuda).manual_seed(n + B)
    if b == 1:
        t = inc.RHT(torch.ones(n, device=cuda), inc._hadamard(6, device=cuda),
                    None, n)
    else:
        t = inc.gen_rht(rots, n, device=cuda)
    assert (t.a, t.b) == (a, b)
    vec = t.signs / (torch.rand(n, generator=g, device=cuda) + 0.5)
    x = torch.randn(B, n, generator=g, device=cuda).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for tr in (False, True):
        before = K3.launches
        got = K3.rht_apply_fused(x, vec, t.left, t.right, transpose=tr)
        assert K3.launches == before + 1 and got.dtype == dtype
        want = K3.rht_apply_fused_ref(x, vec, t.left, t.right, transpose=tr)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max())
        assert err.item() <= tol
    y = K3.rht_apply_fused(x, t.signs, t.left, t.right)
    back = K3.rht_apply_fused(y, t.signs, t.left, t.right, transpose=True)
    rt = (back.float() - x.float()).abs().max() / x.float().abs().max()
    assert rt.item() <= (4e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B,tile_m", [(1, 128), (3, 384), (9, 128),
                                      (5, 384), (8, 128), (13, 384)])
def test_k1p_matches_plain_and_k1(cuda, bits, B, tile_m):
    """One launch; d = 1408 splits the groups of word rows unevenly and
    leaves the 1-bit plane of 3-bit a ragged last group."""
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + B)
    m, d = 384, 1408
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[bits])
    scale = torch.tensor(0.03, device=cuda)
    x = torch.randn(B, d, generator=g, device=cuda).bfloat16().float()
    before = SD.launches
    got = SD.slabdot_matmul(x, planes, scale, bits=bits, tile_m=tile_m)
    assert SD.launches == before + 1
    want = SD.slabdot_matmul_ref(x, planes, scale, bits=bits)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    k1 = DM.dequant_matmul(x, planes, scale, None, bits=bits)
    assert ((got - k1).abs().max() / k1.abs().max()).item() <= 2e-2
    got16 = SD.slabdot_matmul(x.bfloat16(), planes, scale, bits=bits,
                              tile_m=tile_m)
    assert got16.dtype == torch.bfloat16
    assert ((got16.float() - want).abs().max()
            / want.abs().max()).item() <= 1e-2


@pytest.mark.parametrize("m,d,B,tile_m", [
    (4096, 4096, 1, 512), (1280, 128, 13, 1280), (256, 96, 3, 128)])
def test_k1p_shapes_and_reproducible(cuda, m, d, B, tile_m):
    """A decode shape with 8 splits, two chunks of partials (8 rows x 1280
    columns), x staged pair by pair (d = 96), 3-bit: plain within 1e-3, and
    the splits add in a fixed order, so a second call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(m + d + B)
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[3])
    scale = torch.tensor(0.01, device=cuda)
    x = torch.randn(B, d, generator=g, device=cuda).bfloat16().float()
    got = SD.slabdot_matmul(x, planes, scale, bits=3, tile_m=tile_m)
    want = SD.slabdot_matmul_ref(x, planes, scale, bits=3)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    again = SD.slabdot_matmul(x, planes, scale, bits=3, tile_m=tile_m)
    assert torch.equal(got, again)


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.randn(2, 64, device=cuda)
    plane = torch.zeros(4, 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        DM.dequant_matmul(x, (plane.t().contiguous(),), 1.0, None, bits=2)
    q = torch.randn(1, 8, 2, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        FA.flash_prefill_bshd(q, q, q, None, scale=1.0)
    eye = torch.eye(8, device=cuda)
    with pytest.raises(ValueError):           # a non-contiguous factor
        K3.rht_apply_fused(x, torch.ones(64, device=cuda), eye,
                           torch.randn(8, 8, device=cuda).t())
    with pytest.raises(ValueError):           # f64 activations
        K3.rht_apply_fused(x.double(), torch.ones(64, device=cuda), eye, eye)
    with pytest.raises(ValueError):           # tile_m does not divide m
        SD.slabdot_matmul(x, (plane,), 1.0, bits=2, tile_m=128)


# ---------------------------------------------------------------------------
# The chunked loop on the card: chunk graphs (serve/graphs.py) and the pump
# ---------------------------------------------------------------------------


def _engine(cuda, cfg, model, **kw):
    from quip_tpu_torch.serve.engine import Engine
    return Engine(model, cfg, device=cuda, **kw)


def test_chunk_graph_replay_matches_eager(cuda):
    """A chunk's graph, replayed from the same state, gives the eager
    chunk's tokens, hot ring, frontier and cursors bit for bit, and
    counts the launches the eager chunk counted."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_llama
    cfg = get_config("llama-tiny")
    model = packed_llama(cfg, bits=2, seed=0, dtype=torch.float32,
                         head_bits=2, device=cuda)
    eng = _engine(cuda, cfg, model, max_batch=2, max_seq=64, hot=16, page=8)
    eng.submit([5, 6, 7], max_new_tokens=20)
    eng.submit(list(range(1, 12)), max_new_tokens=20)
    eng._admit()
    active = [0, 1]
    eng._frontier_from_host(active)
    eng._push_cursors(np.zeros(2, np.float32), np.ones(2, np.float32))
    state = (eng.pkv.hot_k, eng.pkv.hot_v, eng._tok, eng._hot_d)
    saved = [t.clone() for t in state]
    args = (4, 2, True, 0, False)
    key = eng._chunk_key(*args)
    d0 = DM.launches_decode
    eager = eng._graphs.run(key, eng._chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    n_eager = DM.launches_decode - d0
    after = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    replay = eng._graphs.run(key, eng._chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    assert len(eng._graphs) == 1 and n_eager == 4 * (4 * 2 + 1)
    assert DM.launches_decode - d0 == 2 * n_eager
    assert torch.equal(replay, eager)
    for t, a in zip(state, after):
        assert torch.equal(t, a)


@pytest.mark.parametrize("fused", [False, True])
def test_pump_equals_serial_step(cuda, fused, monkeypatch):
    """Greedy tokens of the pump (chunk graphs) equal the serial step's on
    a 2-layer full-width 2-bit Llama-2-7B: bf16 KV un-fused, then
    QUIP_FUSED_RHT=1 with int8 KV and a shared prefix; warmup first. The
    requests share a budget and start together, as phase 7's do, so the
    two loops flush at the same steps and do the same bf16 arithmetic."""
    import dataclasses

    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_llama
    monkeypatch.setenv("QUIP_FUSED_RHT", "1" if fused else "0")
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_llama(cfg, bits=2, seed=1, dtype=torch.bfloat16,
                         head_bits=2, device=cuda)
    g = torch.Generator().manual_seed(2)
    prompt = lambda n: torch.randint(0, cfg.vocab_size, (n,),  # noqa: E731
                                     generator=g).tolist()
    kw = dict(max_batch=2, max_seq=256, hot=32, page=64,
              cache_dtype=torch.bfloat16)
    if fused:
        kw.update(kv_quant=True, shared_prefix=prompt(40))
    reqs = [dict(prompt=prompt(n), max_new_tokens=40) for n in (70, 5)]
    serial = _engine(cuda, cfg, model, **kw).run(reqs)
    eng = _engine(cuda, cfg, model, **kw).warmup()
    assert len(eng._graphs) >= 8
    pumped = eng.run(reqs, chunked=True)
    assert [r.generated for r in pumped] == [r.generated for r in serial]
    assert eng._t_pump["chunks"] > 0


def test_capture_failure_raises(cuda):
    """A chunk that cannot be captured raises from the engine's graph
    cache and leaves no graph behind: nothing falls back to eager
    execution. In a child process, since a failed capture leaves the
    process's default CUDA generator unusable."""
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from quip_tpu_torch.serve.graphs import ChunkGraphs\n"
        "dev = torch.device('cuda')\n"
        "graphs = ChunkGraphs(dev, torch.Generator(device=dev))\n"
        "x = torch.ones(4, device=dev)\n"
        "calls = []\n"
        "def fn():\n"
        "    calls.append(1)\n"
        "    return x * float(x.sum())    # a host read inside the chunk\n"
        "try:\n"
        "    graphs.run('chunk', fn)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, len(calls), len(graphs))\n"
        "else:\n"
        "    print('no error', len(calls), len(graphs))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split()[:1] == ["raised"], (out.stdout, out.stderr)
    assert out.stdout.split()[2:] == ["2", "0"], out.stdout


def _quant_case(cuda, m=512, d=1024, seed=0):
    """A weight, a PSD Hessian (from 2d samples) and a drawn rotation."""
    from quip_tpu_torch.quantize.pipeline import draw_rotation
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(m, d, generator=g)
    X = torch.randn(2 * d, d, generator=g)
    H = X.t() @ X / (2 * d) + 0.01 * torch.eye(d)
    rot = draw_rotation(torch.Generator().manual_seed(seed + 1), m, d)
    return W, H, rot


def test_quantize_layer_ignores_global_tf32(cuda):
    """quantize_layer runs with TF32 off whatever the caller set, and
    restores the caller's setting: with TF32 on globally the codes are the
    ones of a run with it off."""
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.pipeline import quantize_layer
    W, H, rot = _quant_case(cuda)
    cfg = QuantConfig.incoherence(2, "ldlq")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        off = quantize_layer(W.to(cuda), H.to(cuda), cfg, rot=rot)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        on = quantize_layer(W.to(cuda), H.to(cuda), cfg, rot=rot)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])
    assert torch.equal(on.codes, off.codes)


def test_ldl_factor_raises_on_singular_hessian(cuda):
    """torch's Cholesky on the card reports failure through info (where
    jnp.linalg.cholesky would return NaNs): the solver raises."""
    from quip_tpu_torch.core.ldlq import ldl_factor
    H = torch.ones(64, 64, device=cuda)
    with pytest.raises(torch.linalg.LinAlgError, match="positive definite"):
        ldl_factor(H)


def test_quantize_layer_card_matches_cpu(cuda):
    """One layer quantized on the card and on the CPU in f32: the same
    rotation and inputs give at least 99.9 % equal codes (summation order
    differs; a code within f32 rounding of a boundary may flip and feed
    its row)."""
    from quip_tpu_torch.quantize.config import QuantConfig
    from quip_tpu_torch.quantize.pipeline import quantize_layer
    W, H, rot = _quant_case(cuda, seed=3)
    cfg = QuantConfig.incoherence(2, "ldlq")
    cpu = quantize_layer(W, H, cfg, rot=rot)
    card = quantize_layer(W.to(cuda), H.to(cuda), cfg, rot=rot)
    share = (card.codes.cpu() == cpu.codes).float().mean().item()
    assert share >= 0.999, share
    assert abs(float(card.error) / float(cpu.error) - 1) < 1e-3


def test_ppl_window_packed_matches_unpacked(cuda, monkeypatch):
    """One 2048-token perplexity window of a 2-layer full-width 2-bit
    Llama-2-7B (packed lm_head) through the kernels: 9 K1-tile launches at
    2048 rows and 2 K2 launches at S = 2048; its mean nll a token within
    2e-2 nats of the same weights unpacked to f32 with dense attention
    (bf16 activations against f32)."""
    import dataclasses

    from quip_tpu_torch.eval.ppl import window_nll
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_llama
    from quip_tpu_torch.pack.model import unpack_model
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_llama(cfg, bits=2, seed=4, dtype=torch.bfloat16,
                         head_bits=2, device=cuda)
    g = torch.Generator().manual_seed(4)
    tk = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g).to(cuda)
    t0, d0, k2 = DM.launches_tile, DM.launches_decode, FA.launches
    with torch.inference_mode():
        got = window_nll(model, tk, cfg)
    torch.cuda.synchronize()
    assert (DM.launches_tile - t0, DM.launches_decode - d0,
            FA.launches - k2) == (4 * 2 + 1, 0, 2)
    ref_model = unpack_model(model, torch.float32)
    monkeypatch.setenv("QUIP_FLASH_PREFILL", "0")
    with torch.inference_mode():
        want = window_nll(ref_model, tk, cfg)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert abs(float(got[0] - want[0])) / 2047 <= 2e-2
