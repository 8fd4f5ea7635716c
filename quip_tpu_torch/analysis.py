"""Analysis / verification tools (port of ``quip_tpu/analysis.py``;
reference scripts, SURVEY.md §2.4):

  * Hessian saving     — opt_saveH.py (driver.save_hessians + npz IO here,
                         quip_tpu's npz keys)
  * proxy-loss eval    — opt_proxy.py:227-263 (quantize selected linears
                         against saved Hessians, report tr(ΔW H ΔWᵀ))
  * Hessian summary    — compute_Hsummary.py:18-31 (tr(D)/tr(H), rank at
                         rtol {0, 0.01}, incoherence μ)
  * OPTQ ≡ LDLQ check  — optq_ldlq_equiv.py
  * the counterexample — optq_counter.py:7-43 (quip_tpu's ``tools
                         counter``: the rounders' proxy losses on an
                         adversarial H)

Precision: quip_tpu summarises in float64 where JAX has x64 on (its CPU
runs) and float32 otherwise; the port uses float64 on the CPU and float32
on the card.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def save_hessians_npz(path: str, hessians: Dict[str, torch.Tensor]) -> None:
    """Write per-linear Hessians to one npz keyed by linear name
    (opt_saveH.py:165-166 saved one .pt a layer)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _np(v) for k, v in hessians.items()})


def load_hessians_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def hessian_summary(H, percdamp: float = 0.01, device=None
                    ) -> Tuple[float, float, float, float]:
    """(tr(D)/tr(H), rank/n at rtol 0, rank/n at rtol 0.01, incoherence μ)
    of the damped H (compute_Hsummary.py:18-31), on ``device`` (default:
    H's own, the CPU for a numpy H). H is symmetric, so its singular
    values are the magnitudes of the eigenvalues that the same ``eigh``
    gives with the eigenvectors μ reads."""
    H = torch.as_tensor(H)
    dev = torch.device(device) if device is not None else H.device
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    H = H.to(device=dev, dtype=dtype)
    n = H.shape[0]
    damp = percdamp * torch.mean(torch.diagonal(H))
    H = H + damp * torch.eye(n, dtype=dtype, device=dev)
    L = torch.linalg.cholesky(H)
    a = float(torch.sum(torch.square(torch.diagonal(L))) / torch.trace(H))
    ev, Q = torch.linalg.eigh(H)
    sv = torch.sort(ev.abs(), descending=True).values
    eps = torch.finfo(dtype).eps
    k00 = float(torch.sum(sv > sv[0] * n * eps) / n)
    k01 = float(torch.sum(sv > sv[0] * 0.01) / n)
    mu = float(Q.abs().max() * np.sqrt(n))
    return a, k00, k01, mu


def eigenspectrum_csv(path: str, hessians: Dict[str, np.ndarray],
                      percdamp: float = 0.01) -> None:
    """Per-Hessian eigenvalue spectra as CSV, one column a linear,
    descending (compute_Hsummary.py:72-83), in float64."""
    cols = {}
    for name, H in hessians.items():
        H = _np(H).astype(np.float64)
        Hd = H + percdamp * np.mean(np.diag(H)) * np.eye(H.shape[0])
        cols[name] = np.linalg.eigvalsh(Hd)[::-1]
    width = max(len(v) for v in cols.values())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(cols.keys()) + "\n")
        for i in range(width):
            f.write(",".join(
                f"{v[i]:.8g}" if i < len(v) else "" for v in cols.values())
                + "\n")


def hessian_summary_sweep(hessians: Dict[str, np.ndarray],
                          percdamp: float = 0.01,
                          pickle_path: Optional[str] = None) -> dict:
    """hessian_summary of each Hessian; optionally pickled
    (compute_Hsummary.py:33-57)."""
    rows = {name: hessian_summary(H, percdamp)
            for name, H in hessians.items()}
    if pickle_path:
        os.makedirs(os.path.dirname(pickle_path) or ".", exist_ok=True)
        with open(pickle_path, "wb") as f:
            pickle.dump(rows, f)
    return rows


def proxy_eval(params, cfg, hessians: Dict[str, np.ndarray], qcfg,
               seed: int = 0, layer_indices: Optional[List[int]] = None,
               layer_names: Optional[List[str]] = None,
               rotations=None) -> Dict[str, float]:
    """Quantize selected linears of ``params`` (un-fused, as
    opt_proxy.py's model) against saved Hessians; return each one's proxy
    loss. No forward runs. Each linear draws from quantize/driver.py's
    generator (``layer_generator(seed, name)``, where quip_tpu folds the
    name into its key); ``rotations(name, m, d)`` can hand the pairs in."""
    from quip_tpu_torch.models import model as M
    from quip_tpu_torch.quantize.driver import layer_generator
    from quip_tpu_torch.quantize.pipeline import quantize_layer

    out: Dict[str, float] = {}
    for li, block in enumerate(params.blocks):
        if layer_indices is not None and li not in layer_indices:
            continue
        for spec in M.linear_specs(cfg):
            if layer_names is not None and spec.name not in layer_names:
                continue
            name = f"layers.{li}.{spec.name}"
            if name not in hessians:
                continue
            W = getattr(getattr(block, spec.path[0]), spec.path[1])
            H = torch.as_tensor(hessians[name]).to(W.device)
            rot = rotations(name, W.shape[1], W.shape[0]) \
                if rotations is not None else None
            res = quantize_layer(W.t(), H, qcfg, rot=rot,
                                 gen=layer_generator(seed, name))
            out[name] = float(res.error)
    return out


def optq_ldlq_equivalence_check(m: int = 256, d: int = 256, bits: int = 4,
                                seed: int = 0, device="cuda") -> dict:
    """Runnable LDLQ ≡ OPTQ check on a synthetic float64 layer
    (optq_ldlq_equiv.py:9-96); returns the agreement statistics. On the
    card unless ``device`` says otherwise (raises without one)."""
    from quip_tpu_torch import resolve_device
    from quip_tpu_torch.core import gptq as gptq_mod
    from quip_tpu_torch.core import grid as grid_mod
    from quip_tpu_torch.core import ldlq

    device = resolve_device(device)

    rng = np.random.default_rng(seed)
    W = rng.standard_normal((m, d))
    X = rng.standard_normal((4 * d, d))
    H = X.T @ X / (4 * d) + 0.01 * np.eye(d)
    Wt = torch.from_numpy(W).to(device)
    Ht = torch.from_numpy(H).to(device)
    g = grid_mod.find_params_qfna(Wt, bits, perchannel=True, sym=False)
    q_gptq = gptq_mod.gptq_round(Wt, Ht, g, qfn="c")
    wq = ldlq.round_ldl_gptqequiv(Wt / g.scale + g.zero, Ht, bits)
    q_ldl = g.scale * (wq - g.zero)
    q_near = grid_mod.quantize_qfna(Wt, g.scale, g.zero, g.maxq)
    diff = (q_gptq - q_ldl).abs()
    return {
        "max_diff": float(diff.max()),
        "avg_diff": float(diff.mean()),
        "frac_agree_1e6": float((diff < 1e-6).double().mean()),
        "proxy_gptq": float(ldlq.hessian_loss(q_gptq - Wt, Ht)),
        "proxy_ldlq": float(ldlq.hessian_loss(q_ldl - Wt, Ht)),
        "proxy_nearest": float(ldlq.hessian_loss(q_near - Wt, Ht)),
    }


def counter_rows(n: int, dtype=torch.float32, device="cuda"
                 ) -> Dict[str, float]:
    """The finite-grid counterexample at size ``n`` (quip_tpu's ``tools
    counter``; optq_counter.py:7-43): four rows of W = 0.499 on a 1-bit
    grid against H = I with 0.499 coupling each pair of columns (plus
    1e-3·I), and the proxy loss tr(ΔW H ΔWᵀ) of LDLQ, LDLQ-RG (no greedy
    passes), allbal (2 passes) and rounding to nearest. quip_tpu's CLI
    computes in float32 (no x64), its tests in float64."""
    from quip_tpu_torch import resolve_device
    from quip_tpu_torch.core import ldlq
    dev = resolve_device(device)
    H = np.eye(n)
    for i in range(0, n - 1, 2):
        H[i, i + 1] = H[i + 1, i] = 0.499
    W = torch.full((4, n), 0.499, dtype=dtype, device=dev)
    H = torch.from_numpy(H + 1e-3 * np.eye(n)).to(device=dev, dtype=dtype)
    loss = lambda Q: float(ldlq.hessian_loss(Q - W, H))  # noqa: E731
    return {"ldlq": loss(ldlq.round_ldl(W, H, 1, 0)),
            "ldlqRG": loss(ldlq.round_ldlqRG(W, H, 1, 0)),
            "allbal(2)": loss(ldlq.round_allbal_sorted(W, H, 1, 2)),
            "nearest": loss(ldlq.round_nearest(W, 1))}
