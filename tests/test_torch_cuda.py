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
@pytest.mark.parametrize("B", [9, 17, 600, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [328, 72])
def test_k1_tile_matches_plain(cuda, bits, qfn, code_bits, B, dtype, m):
    """The tensor-core path: m = 328 leaves a ragged block of 256 columns,
    m = 72 a block of the cluster's two with no columns at all, d = 1408 a
    ragged group of word rows in the 1-bit plane of 3-bit."""
    g = torch.Generator(device=cuda).manual_seed(bits * 100 + B + m)
    d = 1408
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
    """m no multiple of 4 (no tensor map: the ring filled by cp.async,
    counted as such) and d·f no multiple of 64 (x staged pair by pair); 20
    rows go 8 at a time."""
    m, d = 330, 96
    x, planes, scale, zero = _k1_case(cuda, bits, "b", None, m, d, B,
                                      bits * 10 + B)
    before = DM.launches_decode, DM.launches_decode_ragged
    got = DM.dequant_matmul(x.float(), planes, scale, zero, bits=bits)
    assert (DM.launches_decode, DM.launches_decode_ragged) == (
        before[0] + -(-B // 8), before[1] + -(-B // 8))
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
    before = DM.launches_tile, DM.launches_decode, DM.launches_decode_ragged
    got = DM.dequant_matmul(x, (plane,), 0.03, None, bits=2)
    assert (DM.launches_tile, DM.launches_decode,
            DM.launches_decode_ragged) == (before[0], before[1] + 5,
                                           before[2])   # a tensor map
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
                                           (2, 4, 1, 64, [64, 63]),
                                           (2, 16, 2, 1000, [1000, 613]),
                                           (1, 4, 4, 4096, [4096])])
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


def test_k2_takes_an_unaligned_view(cuda):
    """q, k and v as contiguous views at a 2-byte offset: the wrapper
    copies them to the aligned addresses the tensor maps need."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 2 * 600 * 4 * 128
    buf = torch.randn(3 * n + 1, generator=g, device=cuda).bfloat16()
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(2, 600, 4, 128)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    pl = torch.tensor([600, 517], dtype=torch.int32, device=cuda)
    got = FA.flash_prefill_bshd(q, k, v, pl, scale=1 / math.sqrt(128))
    want = FA.flash_prefill_ref(q.float(), k.float(), v.float(), pl,
                                scale=1 / math.sqrt(128))
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
                                   (32000, 128, 250), (64, 64, 1),
                                   (16384, 128, 128)])
@pytest.mark.parametrize("B", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_path_shapes(cuda, n, a, b, B, dtype):
    """The five Llama-2-7B splits of the serving path, OPT-6.7B's and
    BLOOM-7b1's 16384 and a right-factor-free case, both directions, and
    forward-then-transpose against x (f32: 1e-5; bf16: the two roundings,
    4e-2 of max |x|)."""
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


@pytest.mark.parametrize("B", [1, 4])
def test_k3_fused_chain_graph_matches_eager(cuda, B, monkeypatch):
    """A Llama-2-7B layer's four packed linears through qlinear_apply with
    QUIP_FUSED_RHT=1 (K3 -> K1-decode -> K3 each, K3 launched with
    programmatic dependent launch) captured in one CUDA graph: a replay
    gives the eager chain's outputs bit for bit (both kernels are
    deterministic), and the first eager call's K3 launches (operands made
    just now) equal the later ones' (operands cached)."""
    from quip_tpu_torch.models.build import random_packed
    from quip_tpu_torch.ops.qlinear import qlinear_apply
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    words = torch.Generator(device=cuda).manual_seed(18)
    rots = torch.Generator().manual_seed(18)
    layers = [random_packed(m, d, 2, words=words, rots=rots, device=cuda)
              for m, d in ((12288, 4096), (4096, 4096), (22016, 4096),
                           (4096, 11008))]
    xs = {d: torch.randn(B, d, device=cuda, generator=words).bfloat16()
          for d in (4096, 11008)}

    def chain():
        return [qlinear_apply(q, xs[q.in_features]) for q in layers]

    before = K3.launches
    first = chain()
    eager = chain()
    assert K3.launches - before == 16
    assert all(torch.equal(u, v) for u, v in zip(first, eager))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = chain()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, eager))


def _captured(fn):
    """(graph, its outputs): ``fn`` run on a side stream, then captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    return graph, got


def test_k3_graph_reads_factors_written_in_place(cuda, monkeypatch):
    """K3 reads bf16 copies of its factors, made once: a CUDA graph
    captured before a factor is written in place replays with the new
    factor. A layer with scaleWH and no vin (4096 x 4096, 'rht') through the
    fused qlinear_apply, its buffers then overwritten by load_state_dict
    of another such layer: the replay equals the other layer's eager
    output bit for bit. K3 alone, its left factor negated in place and
    rht.refresh() called: the replay is within 2e-2 of max |y| of the plain
    version on the new factor."""
    from quip_tpu_torch.models.build import random_packed
    from quip_tpu_torch.ops.qlinear import qlinear_apply
    from quip_tpu_torch.pack.format import PackedLinear
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")

    def layer(seed):
        words = torch.Generator(device=cuda).manual_seed(seed)
        rots = torch.Generator().manual_seed(seed)
        base = random_packed(4096, 4096, 2, words=words, rots=rots,
                             device=cuda)
        rot = {s: (getattr(base, f"{s}_signs"), getattr(base, f"{s}_left"),
                   getattr(base, f"{s}_right")) for s in ("u", "v")}
        swh = torch.rand(4096, generator=rots).to(cuda) + 0.5
        return PackedLinear(base.planes, scale_b=base.scale_b, scaleWH=swh,
                            bits=2, qfn="b", proj_mode="rht",
                            out_features=4096, in_features=4096, rot=rot)

    q, new = layer(1), layer(2)
    x = torch.randn(1, 4096, device=cuda).bfloat16()
    graph, got = _captured(lambda: qlinear_apply(q, x))
    q.load_state_dict(new.state_dict())
    graph.replay()
    want = qlinear_apply(new, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

    t = inc.gen_rht(torch.Generator().manual_seed(5), 11008, device=cuda)
    xs = torch.randn(3, 11008, device=cuda).bfloat16()
    left = t.left.clone()
    before = K3.rht_apply_fused(xs, t.signs, left, t.right)
    graph, got = _captured(lambda: K3.rht_apply_fused(xs, t.signs, left,
                                                      t.right))
    left.neg_()
    K3.refresh()
    graph.replay()
    plain = K3.rht_apply_fused_ref(xs, t.signs, left, t.right).float()
    torch.cuda.synchronize()
    top = plain.abs().max()
    assert (got.float() - plain).abs().max() <= 2e-2 * top
    assert (got.float() - before.float()).abs().max() > 0.5 * top


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


def test_k1p_waits_for_the_kernel_that_writes_its_x(cuda):
    """K1′ goes out under programmatic dependent launch: it may start while
    the kernel before it runs, but stages x only after griddepcontrol.wait.
    A chain of K1′ calls, each one's output the next one's x (d = m), the
    output buffers handed out by the allocator from a block just filled
    with NaN: each call equals its plain version on the x the call before
    wrote (a read before that kernel's stores would read NaN)."""
    g = torch.Generator(device=cuda).manual_seed(19)
    m = d = 2048
    planes = [tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                  dtype=torch.int32, generator=g,
                                  device=cuda)
                    for fb, _ in PLANE_SPLITS[2]) for _ in range(4)]
    scale = torch.tensor(0.002, device=cuda)
    x = torch.randn(1, d, generator=g, device=cuda).bfloat16()
    chain = [x]
    for p in planes:
        junk = torch.full((1, m), float("nan"), device=cuda,
                          dtype=torch.bfloat16)
        del junk                   # the allocator hands its block out next
        chain.append(SD.slabdot_matmul(chain[-1], p, scale, bits=2,
                                       tile_m=512))
    torch.cuda.synchronize()
    for xin, y, p in zip(chain, chain[1:], planes):
        want = SD.slabdot_matmul_ref(xin.float(), p, scale, bits=2)
        assert torch.isfinite(y).all()
        assert ((y.float() - want).abs().max()
                / want.abs().max()).item() <= 1e-2


@pytest.mark.parametrize("bits", [2, 3])
def test_k1p_graph_replay_matches_eager(cuda, bits):
    """K1′ captured in a CUDA graph (the microbenchmark times it so), its
    x then written in place: a replay gives the eager call's output on the
    new x bit for bit (the splits add in a fixed order), within 1e-2 of the
    plain version (bf16 out)."""
    g = torch.Generator(device=cuda).manual_seed(bits)
    m, d = 1280, 1408
    planes = tuple(torch.randint(-2 ** 31, 2 ** 31, (d * fb // 32, m),
                                 dtype=torch.int32, generator=g, device=cuda)
                   for fb, _ in PLANE_SPLITS[bits])
    scale = torch.tensor(0.01, device=cuda)
    x = torch.randn(5, d, generator=g, device=cuda).bfloat16()
    before = SD.launches
    graph, got = _captured(lambda: SD.slabdot_matmul(x, planes, scale,
                                                     bits=bits, tile_m=640))
    assert SD.launches == before + 2      # the side stream's, the capture's
    x.copy_(torch.randn(5, d, generator=g, device=cuda))
    graph.replay()
    eager = SD.slabdot_matmul(x, planes, scale, bits=bits, tile_m=640)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    want = SD.slabdot_matmul_ref(x.float(), planes, scale, bits=bits)
    assert ((got.float() - want).abs().max()
            / want.abs().max()).item() <= 1e-2


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
    return Engine(model, cfg, paged=True, device=cuda, **kw)


def test_chunk_graph_replay_matches_eager(cuda):
    """A chunk's graph, replayed from the same state, gives the eager
    chunk's tokens, hot ring, frontier and cursors bit for bit, and
    counts the launches the eager chunk counted."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    cfg = get_config("llama-tiny")
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
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


def test_later_chunk_graph_replays_at_first_use(cuda):
    """Only the first key of a family (serve/engine.py::_graph_family)
    runs its chunk eagerly before the capture; a later key of the family
    (another chunk length) is captured at once and replayed for the
    caller's chunk: its tokens, hot ring, frontier and cursors equal
    the same chunk run eagerly from the same state, bit for bit, and its
    first use counts the launches of one chunk."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    cfg = get_config("llama-tiny")
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
                         head_bits=2, device=cuda)
    eng = _engine(cuda, cfg, model, max_batch=2, max_seq=64, hot=16, page=8)
    eng.submit([5, 6, 7], max_new_tokens=20)
    eng.submit(list(range(1, 12)), max_new_tokens=20)
    eng._admit()
    eng._frontier_from_host([0, 1])
    eng._push_cursors(np.zeros(2, np.float32), np.ones(2, np.float32))
    state = (eng.pkv.hot_k, eng.pkv.hot_v, eng._tok, eng._hot_d)
    saved = [t.clone() for t in state]
    first = (2, 2, True, 0, False)
    eng._graphs.run(eng._chunk_key(*first), eng._chunk_fn(*first))
    for t, s in zip(state, saved):
        t.copy_(s)
    args = (4, 2, True, 0, False)
    d0 = DM.launches_decode
    got = eng._graphs.run(eng._chunk_key(*args), eng._chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    assert len(eng._graphs) == 2
    assert DM.launches_decode - d0 == 4 * (4 * 2 + 1)
    after = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    eager = eng._chunk_fn(*args)().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    for t, a in zip(state, after):
        assert torch.equal(t, a)


def test_fused_family_runs_eagerly_before_its_capture(cuda, monkeypatch):
    """A chunk key of a new family (the fused RHT switched on after an
    un-fused key was captured) runs its chunk eagerly before its capture,
    so K3's bf16 operands are cached outside the graph; the next key of
    that family (another chunk length) prepares none in its capture. Its
    graph replays the eager chunk's tokens bit for bit. A 1-layer
    full-width 2-bit Llama-2-7B in bf16."""
    import dataclasses

    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.engine import _graph_family
    monkeypatch.setenv("QUIP_FUSED_RHT", "0")
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=1)
    model = packed_model(cfg, bits=2, seed=3, dtype=torch.bfloat16,
                         head_bits=2, device=cuda)
    eng = _engine(cuda, cfg, model, max_batch=2, max_seq=128, hot=16,
                  page=64, cache_dtype=torch.bfloat16)
    eng.submit([5, 6, 7], max_new_tokens=20)
    eng.submit(list(range(1, 12)), max_new_tokens=20)
    eng._admit()
    eng._frontier_from_host([0, 1])
    eng._push_cursors(np.zeros(2, np.float32), np.ones(2, np.float32))
    state = (eng.pkv.hot_k, eng.pkv.hot_v, eng._tok, eng._hot_d)
    saved = [t.clone() for t in state]
    first = (2, 1, True, 0, False)
    eng._graphs.run(eng._chunk_key(*first), eng._chunk_fn(*first))
    n0 = len(K3._cache)
    monkeypatch.setenv("QUIP_FUSED_RHT", "1")
    for t, s in zip(state, saved):
        t.copy_(s)
    eng._graphs.run(eng._chunk_key(*first), eng._chunk_fn(*first))
    assert _graph_family(eng._chunk_key(*first)) in eng._graphs._warm
    n1 = len(K3._cache)
    assert n1 > n0
    for t, s in zip(state, saved):
        t.copy_(s)
    args = (4, 1, True, 0, False)
    warm = len(eng._graphs._warm)
    got = eng._graphs.run(eng._chunk_key(*args), eng._chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    assert len(eng._graphs) == 3 and len(eng._graphs._warm) == warm
    assert len(K3._cache) == n1
    for t, s in zip(state, saved):
        t.copy_(s)
    eager = eng._chunk_fn(*args)().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, eager)


@pytest.mark.parametrize("fused", [False, True])
def test_pump_equals_serial_step(cuda, fused, monkeypatch):
    """Greedy tokens of the pump (chunk graphs) equal the serial step's on
    a 2-layer full-width 2-bit Llama-2-7B: bf16 KV un-fused, then
    QUIP_FUSED_RHT=1 with int8 KV and a shared prefix; warmup first. The
    requests share a budget and start together, as phase 7's do, so the
    two loops flush at the same steps and do the same bf16 arithmetic."""
    import dataclasses

    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    monkeypatch.setenv("QUIP_FUSED_RHT", "1" if fused else "0")
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_model(cfg, bits=2, seed=1, dtype=torch.bfloat16,
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


def test_spec_chunk_graph_replay_matches_eager(cuda):
    """A spec chunk's graph (a one-layer self-draft, K = 2, S = 2),
    replayed from the same state, gives the eager chunk's packed tokens
    and counts, both hot rings, the frontier and the cursors bit for bit,
    and counts the eager chunk's launches again."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.speculative import make_self_draft
    cfg = get_config("llama-tiny")
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
                         head_bits=2, device=cuda)
    eng = _engine(cuda, cfg, model, max_batch=2, max_seq=64, hot=16, page=8,
                  draft=make_self_draft(model, cfg, 1), spec_k=2)
    eng.submit([5, 6, 7], max_new_tokens=20)
    eng.submit(list(range(1, 12)), max_new_tokens=20)
    eng._admit()
    eng._frontier_from_host([0, 1])
    eng._push_cursors(np.zeros(2, np.float32), np.ones(2, np.float32))
    eng._act_d.fill_(1)
    state = (eng.pkv.hot_k, eng.pkv.hot_v, eng.dkv.hot_k, eng.dkv.hot_v,
             eng._tok, eng._hot_d)
    saved = [t.clone() for t in state]
    args = (2, 2, True, False, False)
    key = eng._spec_key(*args)
    d0 = DM.launches_decode
    eager = eng._graphs.run(key, eng._spec_chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    n_eager = DM.launches_decode - d0
    after = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    replay = eng._graphs.run(key, eng._spec_chunk_fn(*args)).clone()
    torch.cuda.synchronize()
    # 2 iterations of 2 draft steps (1 layer: 4 linears and the head) and
    # a 4-row verify (2 layers)
    assert len(eng._graphs) == 1 and n_eager == 2 * (2 * 5 + 9)
    assert DM.launches_decode - d0 == 2 * n_eager
    assert torch.equal(replay, eager)
    for t, a in zip(state, after):
        assert torch.equal(t, a)


def test_spec_pump_greedy_on_card(cuda):
    """The spec pump on the card (graph replays, device cursors, flushes
    in flight) gives the plain serial loop's greedy tokens on llama-tiny
    in f32, with a self-draft and with an unrelated draft."""
    from quip_tpu_torch.models import get_config
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.serve.speculative import make_self_draft
    cfg = get_config("llama-tiny")
    model = packed_model(cfg, bits=2, seed=0, dtype=torch.float32,
                         head_bits=2, device=cuda)
    other = packed_model(cfg, bits=2, seed=1, dtype=torch.float32,
                         head_bits=2, device=cuda)
    kw = dict(max_batch=2, max_seq=64, hot=8, page=8)
    reqs = [dict(prompt=[1, 2, 3], max_new_tokens=25),
            dict(prompt=[4, 5], max_new_tokens=9),
            dict(prompt=[9], max_new_tokens=17)]
    want = [r.generated for r in _engine(cuda, cfg, model, **kw).run(reqs)]
    for draft in (make_self_draft(model, cfg, 1), (other, cfg)):
        eng = _engine(cuda, cfg, model, draft=draft, spec_k=2, **kw)
        got = eng.run(reqs, chunked=True)
        assert [r.generated for r in got] == want
        assert len(eng._graphs) > 0 and eng._flush_epoch > 0


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
    from quip_tpu_torch.models.build import packed_model
    from quip_tpu_torch.pack.model import unpack_model
    cfg = dataclasses.replace(get_config("llama-2-7b"), n_layers=2)
    model = packed_model(cfg, bits=2, seed=4, dtype=torch.bfloat16,
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
