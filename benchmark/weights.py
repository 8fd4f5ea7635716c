"""Raw weights from the seed, and the program's model built from them.

Every tensor is drawn on the device by one ``torch.Generator`` seeded with
``--seed``, a few large calls for all layers at once, in the type it is
served in: the packed planes as random int32 words (2-bit qfn-b codes),
the rotations' signs, the odd orthogonal factors where an RHT size is not
a power of two, the biases, norms and embeddings in bfloat16. ``draw``
returns them stacked over layers (the layout ``reference/model.py``
reads); ``build`` hands the same tensors to the program's constructors
(``quip_tpu_torch.models.model`` and ``pack.format.PackedLinear``, 'rht'
mode, the fused serving layout). Drawing twice from one seed on one
device gives the same tensors, so the reference can be handed a fresh
copy once the program's state is freed.
"""
from __future__ import annotations

import torch

from benchmark.reference import model as RM
from benchmark.reference import planes as P


def shape_of(conf: dict) -> dict:
    """The sizes the weights, the reference and the roofline read, from a
    configuration file: the published ``config.json`` keys of its family
    (OPT: ``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``ffn_dim``, ``vocab_size``, ``max_position_embeddings``, LayerNorm eps
    1e-5 as in the published code; BLOOM: ``hidden_size``, ``n_layer``,
    ``n_head``, ``vocab_size``, ``layer_norm_epsilon``, its MLP 4 ×
    hidden_size as in the published code unless ``ffn_dim`` says
    otherwise, no position table) and the
    quantisation (``bits``, ``scale_b``). The harness draws qfn-b codes
    with 'rht' rotations and serves bfloat16 activations and KV; a file
    that states otherwise is refused."""
    fixed = dict(qfn="b", proj_mode="rht", activation_dtype="bfloat16",
                 kv_dtype="bfloat16")
    for k, v in fixed.items():
        if conf.get(k, v) != v:
            raise ValueError(f"{k}={conf[k]!r}: the harness serves {v!r}")
    fam = conf["family"]
    if fam == "opt":
        s = dict(d_model=conf["hidden_size"],
                 n_layers=conf["num_hidden_layers"],
                 n_heads=conf["num_attention_heads"], d_ff=conf["ffn_dim"],
                 max_pos=conf["max_position_embeddings"], eps=1e-5)
    elif fam == "bloom":
        s = dict(d_model=conf["hidden_size"], n_layers=conf["n_layer"],
                 n_heads=conf["n_head"],
                 d_ff=conf.get("ffn_dim", 4 * conf["hidden_size"]),
                 max_pos=conf["seq_length"],
                 eps=conf["layer_norm_epsilon"])
    else:
        raise ValueError(f"no reference for family {fam!r}")
    return dict(family=fam, vocab=conf["vocab_size"], bits=conf["bits"],
                scale_b=conf["scale_b"], **s)


def check_preset(shape: dict, cfg) -> None:
    """The program's preset must be the configuration's model."""
    got = dict(family=cfg.family, d_model=cfg.d_model,
               n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, eps=cfg.norm_eps)
    want = {k: shape[k] for k in got}
    if got != want:
        raise ValueError(f"preset {got} is not the configuration {want}")


def _orthogonal(gen, count: int, b: int, device) -> torch.Tensor:
    """(count, b, b) random orthogonal matrices (QR of a Gaussian, the
    signs of R's diagonal folded in)."""
    g = torch.randn((count, b, b), generator=gen, device=device)
    q, r = torch.linalg.qr(g)
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return (q * d[:, None, :]).contiguous()


def _signs(gen, shape, device) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=gen, device=device)
    return (bits * 2 - 1).to(torch.float32)


def draw(shape: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, D, V = shape["n_layers"], shape["d_model"], shape["vocab"]
    bits = shape["bits"]

    def normal(*sz, std=0.02, mean=0.0):
        return (torch.randn(sz, generator=gen, device=device) * std
                + mean).to(dtype)

    lin = {}
    for name, (m, d) in RM.shapes(shape).items():
        ent = {"plane": torch.randint(
            -2 ** 31, 2 ** 31, (L, d * bits // 32, m), dtype=torch.int32,
            generator=gen, device=device),
            "u_signs": _signs(gen, (L, m), device),
            "v_signs": _signs(gen, (L, d), device)}
        for side, n in (("u", m), ("v", d)):
            a, b = P.split(n)
            ent[f"{side}_right"] = (_orthogonal(gen, L, b, device)
                                    if b > 1 and b & (b - 1) else None)
        lin[name] = ent
    ln = torch.stack([normal(L, 2, D, std=0.1, mean=1.0),
                      normal(L, 2, D, std=0.1)], dim=2)   # (L, 2, 2, D)
    bias = {n: normal(L, m) for n, (m, _) in RM.shapes(shape).items()}
    raw = dict(lin=lin, ln=ln, bias=bias, tok=normal(V, D),
               final_ln=torch.stack([normal(D, std=0.1, mean=1.0),
                                     normal(D, std=0.1)]))
    if shape["family"] == "opt":
        raw["pos"] = normal(shape["max_pos"] + 2, D)
    else:
        # BLOOM's embedding LayerNorm at 0.3 scale: at unit scale the
        # token's own (tied) embedding carries every position's logits
        # (about 10 against 6 for the best of the rest), so each served
        # token repeats the last and no check can see the arithmetic
        raw["emb_ln"] = torch.stack([normal(D, std=0.03, mean=0.3),
                                     normal(D, std=0.03)])
    return raw


def build(raw: dict, shape: dict, cfg):
    """The program's ``Model`` over the raw tensors (shared, not copied):
    each linear a 'rht' ``PackedLinear`` whose rotation is the raw signs,
    the Hadamard factors and the raw orthogonal factor."""
    from quip_tpu_torch.models.model import (MLP, Attention, Block, Embed,
                                             Model, Norm)
    from quip_tpu_torch.pack.format import PackedLinear

    dev = raw["tok"].device
    had = {}

    def factors(n, right):
        a, b = P.split(n)
        if a not in had:
            had[a] = P.hadamard(a, dev)
        if b == 1:
            return had[a], ()
        if b & (b - 1) == 0:
            if b not in had:
                had[b] = P.hadamard(b, dev)
            return had[a], had[b]
        return had[a], right

    def packed(name, layer):
        e = raw["lin"][name]
        m, d = RM.shapes(shape)[name]
        pick = lambda k: None if e[k] is None else e[k][layer]  # noqa: E731
        us, vs = e["u_signs"][layer], e["v_signs"][layer]
        rot = {"u": (us, *factors(m, pick("u_right"))),
               "v": (vs, *factors(d, pick("v_right"))), "vin": vs}
        return PackedLinear(
            (e["plane"][layer],),
            scale_b=torch.tensor(shape["scale_b"], dtype=torch.float32,
                                 device=dev),
            bits=shape["bits"], qfn="b", proj_mode="rht", out_features=m,
            in_features=d, rot=rot)

    def norm(p):
        return Norm(p[0], p[1])

    blocks = []
    for i in range(shape["n_layers"]):
        b = {n: raw["bias"][n][i] for n in RM.LINEARS}
        attn = Attention(wqkv=packed("qkv", i), wo=packed("o", i),
                         bqkv=b["qkv"], bo=b["o"])
        mlp = MLP(w1=packed("fc1", i), w2=packed("fc2", i), b1=b["fc1"],
                  b2=b["fc2"])
        blocks.append(Block(norm(raw["ln"][i][0]), norm(raw["ln"][i][1]),
                            attn, mlp))
    emb = Embed(raw["tok"], raw.get("pos"), None, None,
                ln=norm(raw["emb_ln"]) if "emb_ln" in raw else None)
    return Model(cfg, emb, blocks, norm(raw["final_ln"]), None)
