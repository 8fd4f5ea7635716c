"""Analysis tools CLI (port of ``quip_tpu/cli/tools.py``; reference
opt_saveH.py, opt_proxy.py, compute_Hsummary.py, optq_ldlq_equiv.py,
optq_counter.py and load_quant): quip_tpu's save-hessians, proxy,
hsummary, equiv-check, transcode and counter subcommands, with its flags
and outputs plus ``--device``:

  python -m quip_tpu_torch.cli.tools save-hessians llama-tiny synthetic \\
      --out H.npz --device cpu
  python -m quip_tpu_torch.cli.tools proxy llama-tiny --hessians H.npz \\
      --wbits 2 --quant ldlq --incoh_processing --device cpu
  python -m quip_tpu_torch.cli.tools hsummary --hessians H.npz
  python -m quip_tpu_torch.cli.tools equiv-check
  python -m quip_tpu_torch.cli.tools transcode --load CKPT --save DENSE \\
      --device cpu
  python -m quip_tpu_torch.cli.tools counter --sizes 64,256 --device cpu
"""
from __future__ import annotations

import argparse
import json
import pickle

import numpy as np
import torch

from quip_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("quip_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("save-hessians",
                        help="calibrate and dump per-layer Hessians "
                             "(opt_saveH.py parity)")
    common.add_model_args(ps)
    common.add_data_args(ps)
    ps.add_argument("--out", required=True)
    ps.add_argument("--chunk", type=int, default=4)

    pp = sub.add_parser("proxy", help="proxy-loss eval from saved Hessians "
                                      "(opt_proxy.py parity)")
    common.add_model_args(pp)
    common.add_quant_args(pp)
    pp.add_argument("--hessians", required=True)
    pp.add_argument("--layers", type=str, default=None,
                    help="comma list of block indices")
    pp.add_argument("--names", type=str, default=None,
                    help="comma list of linear names (e.g. fc2)")

    ph = sub.add_parser("hsummary", help="Hessian statistics "
                                         "(compute_Hsummary.py parity)")
    ph.add_argument("--hessians", required=True)
    ph.add_argument("--percdamp", type=float, default=0.01)
    ph.add_argument("--eigens_csv", type=str, default=None,
                    help="also dump per-layer eigenvalue spectra "
                         "(compute_Hsummary.py:72-83)")
    ph.add_argument("--pickle", type=str, default=None,
                    help="dump the summary dict as pickle "
                         "(compute_Hsummary.py:33-57)")
    ph.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; tests pass cpu)")

    pe = sub.add_parser("equiv-check",
                        help="LDLQ == OPTQ equivalence (optq_ldlq_equiv.py)")
    pe.add_argument("--m", type=int, default=256)
    pe.add_argument("--d", type=int, default=256)
    pe.add_argument("--wbits", type=int, default=4)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; tests pass cpu)")

    pt = sub.add_parser("transcode",
                        help="packed checkpoint -> dense checkpoint "
                             "(load_quant parity: rebuild dense weights "
                             "from codes + scales + rotations)")
    pt.add_argument("--load", required=True)
    pt.add_argument("--save", required=True)
    pt.add_argument("--device", type=str, default="cuda",
                    help="torch device the linears are dequantized on "
                         "(default cuda; tests pass cpu)")

    pc = sub.add_parser("counter",
                        help="finite-grid counterexample: rounder proxy "
                             "losses on adversarial (W, H) "
                             "(optq_counter.py:7-43)")
    pc.add_argument("--sizes", type=str, default="256,512,1024,2048,4096")
    pc.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; tests pass cpu)")

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from quip_tpu_torch import analysis, resolve_device

    if args.cmd == "save-hessians":
        params, cfg = common.load_model(args)
        (calib, _), _ = common.get_data(args, cfg)
        from quip_tpu_torch.quantize.driver import save_hessians
        Hs = save_hessians(params, cfg, torch.from_numpy(calib),
                           chunk=args.chunk)
        analysis.save_hessians_npz(args.out, Hs)
        print(f"saved {len(Hs)} Hessians to {args.out}")
        return Hs

    if args.cmd == "proxy":
        params, cfg = common.load_model(args)
        Hs = analysis.load_hessians_npz(args.hessians)
        qcfg = common.quant_config_from_args(args)
        layers = ([int(x) for x in args.layers.split(",")]
                  if args.layers else None)
        names = args.names.split(",") if args.names else None
        errs = analysis.proxy_eval(params, cfg, Hs, qcfg,
                                   getattr(args, "seed", 0),
                                   layer_indices=layers, layer_names=names)
        total = sum(errs.values())
        out = {"per_layer": errs,
               "avg_proxy_error": total / max(len(errs), 1),
               "total": total, "n": len(errs)}
        print(json.dumps(out, indent=2))
        return out

    if args.cmd == "hsummary":
        dev = resolve_device(args.device)
        Hs = analysis.load_hessians_npz(args.hessians)
        rows = []
        for name, H in Hs.items():
            a, k00, k01, mu = analysis.hessian_summary(H, args.percdamp, dev)
            rows.append((name, a, k00, k01, mu))
            print(f"{name}: tr(D)/tr(H)={a:.4f} rank0={k00:.3f} "
                  f"rank.01={k01:.3f} mu={mu:.2f}")
        arr = np.array([[r[1], r[2], r[3], r[4]] for r in rows])
        print(f"tr(D)/tr(H): {arr[:, 0].mean():.4f} "
              f"(+/- {arr[:, 0].std():.4f})")
        print(f"matrix rank rtol=0.00: {arr[:, 1].mean():.4f} "
              f"(+/- {arr[:, 1].std():.4f})")
        print(f"matrix rank rtol=0.01: {arr[:, 2].mean():.4f} "
              f"(+/- {arr[:, 2].std():.4f})")
        print(f"incoherency mu: {arr[:, 3].mean():.4f} "
              f"(+/- {arr[:, 3].std():.4f})")
        if args.eigens_csv:
            analysis.eigenspectrum_csv(args.eigens_csv, Hs, args.percdamp)
            print(f"wrote eigenspectra to {args.eigens_csv}")
        if args.pickle:
            with open(args.pickle, "wb") as f:
                pickle.dump({r[0]: tuple(r[1:]) for r in rows}, f)
            print(f"wrote summary pickle to {args.pickle}")
        return rows

    if args.cmd == "equiv-check":
        out = analysis.optq_ldlq_equivalence_check(
            args.m, args.d, args.wbits, args.seed,
            device=resolve_device(args.device))
        print(json.dumps(out, indent=2))
        assert out["frac_agree_1e6"] > 0.99, "LDLQ != OPTQ!"
        print("EQUIVALENCE OK")
        return out

    if args.cmd == "transcode":
        from quip_tpu_torch.pack.model import transcode
        out = transcode(args.load, args.save, args.device)
        print(f"transcoded {args.load} -> dense at {args.save}")
        return out

    if args.cmd == "counter":
        rows = []
        for n in (int(s) for s in args.sizes.split(",")):
            rows.append({"n": n, **analysis.counter_rows(
                n, torch.float32, args.device)})
            print(json.dumps(rows[-1]))
        return rows

    return None


if __name__ == "__main__":
    main()
