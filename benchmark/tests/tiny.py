"""Tiny cells for the CPU tests: the program's opt-tiny and bloom-tiny
presets under a short open loop and short perplexity windows."""
from __future__ import annotations

import copy

OPT = {"family": "opt", "preset": "opt-tiny", "hidden_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4, "ffn_dim": 128,
       "max_position_embeddings": 128, "vocab_size": 512, "bits": 2,
       "scale_b": 0.02,
       "engine": {"paged": True, "max_batch": 4, "max_seq": 128, "hot": 16,
                  "page": 16}}
BLOOM = {"family": "bloom", "preset": "bloom-tiny", "hidden_size": 64,
         "n_layer": 2, "n_head": 4, "ffn_dim": 128, "layer_norm_epsilon": 1e-5,
         "vocab_size": 512, "seq_length": 128, "bits": 2, "scale_b": 0.02,
         "env": {"QUIP_FUSED_RHT": "1"},
         "engine": {"paged": True, "max_batch": 4, "max_seq": 128,
                    "hot": 16, "page": 16}}
SERVE = {"driver": "serve", "rate_per_s": 40.0, "lead_in_s": 0.3,
         "block": 8, "prompt": {"dist": "loguniform", "min": 33, "max": 60},
         "output": {"dist": "uniform", "min": 8, "max": 40},
         "drain": "first_tokens", "check_requests": 3, "trace_s": 0.3}
PPL = {"driver": "ppl", "seqlen": 64, "batch": 2, "pool": 6,
       "check_windows": 2, "trace_s": 0.3}


# The tiny cells' limits: at this size the program's bf16 run serves the
# reference's first choice at every position (served_gap reads 0: the top
# logits lie far apart) and its loss per token lies within 3e-4 of the
# reference's; an altered token reads 0.86 (OPT) and 1.49 (BLOOM), a
# loss against the wrong targets 0.49.
LIMITS = {"served_gap": 0.05, "nll_gap": 0.01}


def cell(conf: dict, mix: dict) -> dict:
    key = "served_gap" if mix["driver"] == "serve" else "nll_gap"
    limit = LIMITS[key]
    e2e = ([{"name": n, "unit": u} for n, u in (
        ("ttft_p90_ms", "ms"), ("tpot_p90_ms", "ms"),
        ("output_tokens_per_s", "tokens/s"))]
        if mix["driver"] == "serve" else
        [{"name": "scored_tokens_per_s", "unit": "tokens/s"}])
    return {"workload": {"name": "tiny", "chips": 1},
            "config": copy.deepcopy(conf), "mix": copy.deepcopy(mix),
            "limits": {key: {"limit": limit}}, "end_to_end": e2e,
            "per_layer": []}
