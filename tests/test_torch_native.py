"""Port parity for the host packer (quip_tpu_torch/pack/native.py, built
by g++ from pack/csrc/packlib.cpp): its planes against quip_tpu's
``pack_codes`` and quip_tpu's own native library (``pack_np``) bit for
bit at every field and composite width, unpacking both ways, the qfn-b
grid step against quip_tpu's ``dequant_qfnb_np`` (bit for bit) and the
port's torch expression (1e-6 relative), ``pack_codes`` / ``unpack_codes``
on CPU tensors against their torch-ops versions, the table grid step of
``PackedLinear.dequantize`` against its torch expression (bit for bit),
and a failed build that raises instead of falling back.

quip_tpu's library is built here from its own ``native/packlib.cpp`` by
its own Makefile into a temporary directory, so this file never writes
``native/`` while ``tests/test_native.py`` may be building it."""
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_tpu.pack import format as JF
from quip_tpu.pack import native as JN
from quip_tpu_torch.kernels import _build
from quip_tpu_torch.pack import format as TF
from quip_tpu_torch.pack import native as TN

M, D = 37, 256          # a ragged row count


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """quip_tpu.pack.native bound to a library its Makefile built from
    native/packlib.cpp into a temporary directory."""
    out = tmp_path_factory.mktemp("quippack") / "libquippack.so"
    subprocess.run(["make", "-s", "-C", os.path.dirname(JN._LIB_PATH),
                    f"TARGET={out}"], check=True, capture_output=True,
                   timeout=120)
    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "_LIB_PATH", str(out))
    mp.setattr(JN, "_lib", None)
    mp.setattr(JN, "_tried", False)
    assert JN.available()
    yield JN
    mp.undo()


def _codes(bits, m=M, d=D, seed=0):
    return np.random.default_rng(seed + bits).integers(
        0, 2 ** bits, (m, d)).astype(np.uint8)


@pytest.mark.parametrize("kind,bits", [
    ("plane", 1), ("plane", 2), ("plane", 4),
    ("codes", 2), ("codes", 3), ("codes", 4), ("codes", 8)])
def test_planes_match_quip_tpu(jax_native, kind, bits):
    """Field widths through ``pack_plane``, composite widths through
    ``pack``: equal to quip_tpu's jnp planes and its native library's,
    word for word; unpacked back to the codes by both libraries."""
    codes = _codes(bits)
    t = torch.from_numpy(codes)
    if kind == "plane":
        got = (TN.pack_plane(t, bits),)
        want = (JF._pack_plane(jnp.asarray(codes.astype(np.int32)), bits),)
        lib = (jax_native.pack_plane_np(codes, bits),)
        back = TN.unpack_plane(got[0], bits, D)
        jback = jax_native.unpack_plane_np(got[0].numpy(), bits, D)
    else:
        got = TN.pack(t, bits)
        want = JF.pack_codes(jnp.asarray(codes.astype(np.int32)), bits)
        lib = jax_native.pack_np(codes, bits)
        back = TN.unpack(got, bits, D)
        jback = jax_native.unpack_np(tuple(g.numpy() for g in got), bits, D)
    assert len(got) == len(want) == len(lib)
    for g, w, n in zip(got, want, lib):
        assert g.dtype == torch.int32 and g.shape[1] == M
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), n)
    assert back.dtype == (torch.uint8 if kind == "plane" else torch.int32)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(jback, codes)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_codes_cpu_matches_plain(bits):
    """``pack_codes`` / ``unpack_codes`` of CPU int32 codes (the host
    packer) give the planes and codes of the torch-ops plain version."""
    codes = torch.from_numpy(_codes(bits, m=64, d=512).astype(np.int32))
    got = TF.pack_codes(codes, bits)
    shift, want = 0, []
    for fb, _ in TF.PLANE_SPLITS[bits]:
        want.append(TF._pack_plane((codes.long() >> shift) & (2 ** fb - 1),
                                   fb))
        shift += fb
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    back = TF.unpack_codes(got, bits, 512)
    assert back.dtype == torch.int32 and torch.equal(back, codes)
    shift, plain = 0, torch.zeros_like(codes)
    for w, (fb, _) in zip(want, TF.PLANE_SPLITS[bits]):
        plain |= TF._unpack_plane(w, fb, 512) << shift
        shift += fb
    assert torch.equal(back, plain)


@pytest.mark.parametrize("bits", [2, 4])
def test_dequant_qfnb_matches(jax_native, bits):
    codes = _codes(bits, m=64, d=512)
    planes = TN.pack(torch.from_numpy(codes), bits)
    scale = 0.37
    got = TN.dequant_qfnb(planes, bits, 512, scale)
    assert got.dtype == torch.float32 and got.shape == (64, 512)
    want = jax_native.dequant_qfnb_np(tuple(p.numpy() for p in planes), bits,
                                      512, scale)
    np.testing.assert_array_equal(got.numpy(), want)
    q = torch.from_numpy(codes).float()
    ref = ((q / (2 ** bits - 1)) * 2 - 1) * torch.tensor(scale)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * scale)
    with pytest.raises(ValueError):
        TN.dequant_qfnb(TN.pack(torch.from_numpy(codes & 7), 3), 3, 512,
                        scale)


@pytest.mark.parametrize("bits,code_bits", [(2, None), (4, None), (4, 3)])
def test_dequantize_host_grid(bits, code_bits):
    """PackedLinear.dequantize on the CPU takes the host packer's grid step
    (``dequant_table``) for single-plane qfn-b planes, widened 3-bit codes
    (maxq 7) included, and gives the torch expression's float32 values bit
    for bit."""
    codes = torch.from_numpy(_codes(code_bits or bits, m=40, d=256)
                             .astype(np.int32))
    scale = torch.tensor(0.21)
    q = TF.PackedLinear(TF.pack_codes(codes, bits), None, None, scale,
                        None, None, bits=bits, qfn="b",
                        proj_mode="rht", out_features=33, in_features=256,
                        code_bits=code_bits)
    assert q._host_grid(torch.float32) and not q._host_grid(torch.float64)
    maxq = 2 ** (code_bits or bits) - 1
    want = ((codes[:33].float() / maxq) * 2 - 1) * scale
    got = q.dequantize()
    assert got.dtype == torch.float32 and got.shape == (33, 256)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        q.dequantize(torch.float64),
        ((codes[:33].double() / maxq) * 2 - 1) * scale.double(), rtol=0,
        atol=1e-15)
    with pytest.raises(ValueError, match="table of"):
        TN.dequant_table(q.planes, bits, 256, torch.zeros(3))


def test_rejects_bad_input():
    codes = torch.from_numpy(_codes(2))
    with pytest.raises(ValueError, match="divisible"):
        TN.pack_plane(codes[:, :40], 2)
    with pytest.raises(ValueError, match="CPU"):
        TN.pack_plane(codes.to("meta"), 2)
    with pytest.raises(ValueError, match="field width"):
        TN.pack_plane(codes, 3)
    with pytest.raises(ValueError, match="take 2 planes"):
        TN.unpack(TN.pack(codes, 3)[:1], 3, D)


@pytest.mark.parametrize("fault", ["no compiler", "broken source"])
def test_failed_build_raises(fault, tmp_path, monkeypatch):
    """No fallback: with g++ missing from PATH, or a source g++ refuses,
    the first call raises naming the compiler (and the log)."""
    monkeypatch.setattr(_build, "_OUT", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    if fault == "no compiler":
        which = shutil.which
        monkeypatch.setattr(_build.shutil, "which",
                            lambda name: None if name == "g++"
                            else which(name))
        match = r"g\+\+ not found"
    else:
        src = tmp_path / "packlib.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setitem(_build._HOST, "packlib", src)
        match = r"g\+\+ failed for packlib.cpp \(log: "
    with pytest.raises(RuntimeError, match=match):
        TF.pack_codes(torch.zeros((4, 64), dtype=torch.int32), 2)
    assert not list((tmp_path / "_build").glob("*.so"))
