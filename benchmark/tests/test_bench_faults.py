"""A run with the timed path broken underneath must come out not correct,
and the control (the reference in float8) must read above the program:
tiny cells driven on the CPU through the harness's own drivers, past its
look for a card."""
import pytest
import torch

from benchmark import run as R
from benchmark import weights as WT
from benchmark.reference import judge
from benchmark.tests import tiny

SERVE = dict(tiny.SERVE, rate_per_s=4.0, lead_in_s=1.5)


def _drive(conf, mix):
    cell = tiny.cell(conf, mix)
    ctx = R.Ctx(cell, 2 ** 31 + 11, 5.0, False, "cpu")
    out, metrics = R.drive(cell, ctx)
    return R.result_line(cell, ctx, out, metrics, "cpu", 1), out


@pytest.fixture
def token_fault(monkeypatch):
    from quip_tpu_torch.serve import engine as E
    orig = E.Engine._take_tokens

    def take(self, req, toks):
        if toks:
            toks[-1] = (toks[-1] + 1) % self.cfg.vocab_size
        return orig(self, req, toks)
    monkeypatch.setattr(E.Engine, "_take_tokens", take)


@pytest.fixture
def misaligned_loss(monkeypatch):
    import torch.nn.functional as F
    from quip_tpu_torch.eval import ppl
    from quip_tpu_torch.models import model as M

    def window_nll(params, tokens, cfg):
        logits = M.forward(params, tokens, cfg)
        B, S, V = logits.shape
        nll = F.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                              tokens[:, :-1].reshape(-1), reduction="none")
        return nll.view(B, S - 1).sum(-1)
    monkeypatch.setattr(ppl, "window_nll", window_nll)


@pytest.mark.parametrize("conf", [tiny.OPT, tiny.BLOOM],
                         ids=["opt", "bloom"])
def test_serving_run_is_correct(conf):
    line, _ = _drive(conf, SERVE)
    assert line["correct"], line


@pytest.mark.parametrize("conf", [tiny.OPT, tiny.BLOOM],
                         ids=["opt", "bloom"])
def test_altered_token_is_not_correct(conf, token_fault):
    line, _ = _drive(conf, SERVE)
    assert not line["correct"], line


def test_ppl_run_is_correct():
    line, _ = _drive(tiny.OPT, tiny.PPL)
    assert line["correct"], line


def test_altered_loss_is_not_correct(misaligned_loss):
    line, _ = _drive(tiny.OPT, tiny.PPL)
    assert not line["correct"], line


def test_control_reads_above_the_program():
    """The float8 control against the program's bf16 forward, both judged
    by the reference at the same 800 positions of random sequences through
    tiny OPT (at this size the program's own served tokens are too few for
    the control's first choices to differ from the reference's)."""
    from quip_tpu_torch.models import model as M
    from quip_tpu_torch.models.config import get_config
    shape = WT.shape_of(tiny.OPT)
    raw = WT.draw(shape, 5, "cpu")
    model = WT.build(raw, shape, get_config(tiny.OPT["preset"]))
    g = torch.Generator().manual_seed(0)
    seqs = torch.randint(0, shape["vocab"], (8, 100), generator=g)
    from benchmark.reference import model as RM
    with torch.no_grad():
        served = M.forward(model, seqs, model.cfg).argmax(-1)
        ref = RM.rows_from(raw, shape, list(seqs), [0] * 8)
        low = RM.rows_from(raw, shape, list(seqs), [0] * 8, "fp8")
    prog = max(float(judge._gap(r, t).max()) for r, t in zip(ref, served))
    ctl = max(float(judge._gap(r, lo.argmax(-1)).max())
              for r, lo in zip(ref, low))
    assert ctl > 3 * prog


def test_ppl_control_reads_above_the_program():
    _, out = _drive(tiny.OPT, tiny.PPL)
    wins, prog = out.judged
    shape = WT.shape_of(tiny.OPT)
    raw = WT.draw(shape, 2 ** 31 + 11, "cpu")
    with torch.no_grad():
        ref = judge.window_nll(raw, shape, wins)
        low = judge.window_nll(raw, shape, wins, "fp8")
    S = tiny.PPL["seqlen"]
    assert judge.nll_gap(ref, low, S) > judge.nll_gap(ref, prog, S)
