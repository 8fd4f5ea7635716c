"""Port parity: apply_rht forward/transpose on RHT arrays carried over
from quip_tpu (threefry is not ported; the arrays cross as numpy)."""
import jax
import numpy as np
import pytest
import torch

from quip_tpu.core import incoherence as JI
from quip_tpu_torch.core import incoherence as TI


def _carry(t: JI.RHT, signs: bool = True) -> TI.RHT:
    conv = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.array(a, np.float32))
    return TI.RHT(conv(t.signs) if signs else None, conv(t.left),
                  conv(t.right), t.n)


@pytest.mark.parametrize("n", [64, 96, 12288])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rht_matches(n, transpose):
    jt = JI.gen_rht(jax.random.key(n), n)
    tt = _carry(jt)
    assert (tt.a, tt.b) == (jt.a, jt.b) == TI._pow2_split(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(JI.apply_rht(jt, jax.numpy.asarray(x), axis=-1,
                                   transpose=transpose))
    got = TI.apply_rht(tt, torch.from_numpy(x), axis=-1,
                       transpose=transpose).numpy()
    # f32 Kronecker dots in another summation order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    # the sign-free (folded-mode) map, along axis 0
    want0 = np.asarray(JI.apply_rht(jt._replace(signs=None),
                                    jax.numpy.asarray(x.T), axis=0,
                                    transpose=transpose))
    got0 = TI.apply_rht(_carry(jt, signs=False), torch.from_numpy(x.T),
                        axis=0, transpose=transpose).numpy()
    np.testing.assert_allclose(got0, want0, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n", [96, 200])
def test_port_gen_rht_orthogonal(n):
    """The port's own generator (torch.Generator) gives an orthogonal T:
    Tᵀ(T x) = x and |T x| = |x|."""
    t = TI.gen_rht(torch.Generator().manual_seed(0), n)
    assert t.right is not None and set(t.signs.tolist()) <= {-1.0, 1.0}
    x = torch.randn(4, n, generator=torch.Generator().manual_seed(1))
    y = TI.apply_rht(t, x, axis=-1)
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(TI.apply_rht(t, y, axis=-1, transpose=True),
                               x, rtol=1e-5, atol=1e-5)
