"""The plain reference against the program at a tiny size on the CPU:
the same raw tensors through the program's model (float32, its plain
paths) and through the reference give the same logits; the reference's
own decoding of planes and rotations gives the program's dense weights."""
import pytest
import torch

from benchmark import weights as WT
from benchmark.reference import judge
from benchmark.reference import model as RM
from benchmark.reference import planes as P
from benchmark.tests import tiny


def _model(conf, seed=2 ** 31 + 3, dtype=torch.float32):
    from quip_tpu_torch.models.config import get_config
    shape = WT.shape_of(conf)
    raw = WT.draw(shape, seed, "cpu", dtype=dtype)
    cfg = get_config(conf["preset"])
    WT.check_preset(shape, cfg)
    return shape, raw, WT.build(raw, shape, cfg), cfg


@pytest.mark.parametrize("conf", [tiny.OPT, tiny.BLOOM],
                         ids=["opt", "bloom"])
def test_dense_weights_match_the_program(conf):
    shape, raw, model, _ = _model(conf)
    for name, attr in (("qkv", ("attn", "wqkv")), ("o", ("attn", "wo")),
                       ("fc1", ("mlp", "w1")), ("fc2", ("mlp", "w2"))):
        lin = {k: (None if v is None else v[1])
               for k, v in raw["lin"][name].items()}
        m, d = RM.shapes(shape)[name]
        mine = P.dense_weight(lin, shape["bits"], shape["scale_b"], m, d)
        q = getattr(getattr(model.blocks[1], attr[0]), attr[1])
        torch.testing.assert_close(mine, q.dequantize(torch.float32),
                                   rtol=1e-5, atol=1e-6)


def test_unpack_matches_the_program():
    from quip_tpu_torch.pack.format import pack_codes
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 4, (48, 64), generator=g, dtype=torch.int32)
    plane = pack_codes(codes, 2)[0]
    assert torch.equal(P.unpack(plane, 2, 64), codes.to(torch.int64))


@pytest.mark.parametrize("conf", [tiny.OPT, tiny.BLOOM],
                         ids=["opt", "bloom"])
def test_logits_match_the_program(conf):
    from quip_tpu_torch.models import model as M
    shape, raw, model, cfg = _model(conf)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, shape["vocab"], (2, 40), generator=g)
    with torch.no_grad():
        prog = M.forward(model, toks, cfg)
        hs = RM.hidden(raw, shape, [toks[0], toks[1]])
        ref = torch.stack([RM.logits(raw, h) for h in hs])
    torch.testing.assert_close(ref, prog, rtol=1e-4, atol=1e-4)


def test_judge_reads_served_tokens():
    shape, raw, _, _ = _model(tiny.OPT)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, shape["vocab"], (20,), generator=g).tolist()
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(6):       # the reference's own greedy tokens
            h = RM.hidden(raw, shape, [torch.tensor(seq)])[0]
            seq.append(int(RM.logits(raw, h[-1:]).argmax()))
        gen = seq[len(prompt):]
        gap, n = judge.served_gap(raw, shape, [(prompt, gen)])
        assert n == 6 and gap < 1e-5
        bad = list(gen)
        bad[3] = (bad[3] + 1) % shape["vocab"]
        gap_bad, _ = judge.served_gap(raw, shape, [(prompt, bad)])
    assert gap_bad > 1e-3


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    here = pathlib.Path(RM.__file__).parent
    for f in here.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                for n in names:
                    assert n.split(".")[0] in (
                        "torch", "math", "typing", "__future__",
                        "benchmark"), (f.name, n)
                    if n.startswith("benchmark"):
                        assert n.startswith("benchmark.reference"), n
