"""Model family configurations: OPT, Llama(-2), BLOOM.

A copy of ``quip_tpu.models.config`` (the port never imports the JAX
package: its ``__init__`` pulls in jax). One typed config describes the
family differences; ``models/model.py`` serves the Llama family in this
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    family: str                       # 'opt' | 'llama' | 'bloom'
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_seq: int = 2048
    n_kv_heads: Optional[int] = None  # GQA (Llama-2 70B); None = n_heads
    head_dim: Optional[int] = None
    # positional scheme: 'learned' (OPT, offset 2), 'rope' (Llama),
    # 'alibi' (BLOOM)
    positions: str = "learned"
    rope_theta: float = 10000.0
    # norms / activations
    norm: str = "ln"                  # 'ln' | 'rms'
    norm_eps: float = 1e-5
    act: str = "relu"                 # 'relu' | 'silu_glu' | 'gelu'
    do_layer_norm_before: bool = True  # OPT-350m quirk is False
    # OPT word_embed_proj_dim != d_model => project_in/out matrices
    embed_proj_dim: Optional[int] = None
    tie_word_embeddings: bool = True
    # BLOOM applies LayerNorm to the word embeddings
    embed_layer_norm: bool = False
    attn_bias: bool = True
    mlp_bias: bool = True
    dtype: str = "float32"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def _opt(vocab=50272, **kw) -> ModelConfig:
    return ModelConfig(family="opt", vocab_size=vocab, positions="learned",
                       norm="ln", act="relu", **kw)


def _llama(**kw) -> ModelConfig:
    return ModelConfig(family="llama", vocab_size=32000, positions="rope",
                       norm="rms", norm_eps=1e-5, act="silu_glu",
                       tie_word_embeddings=False, attn_bias=False,
                       mlp_bias=False, max_seq=4096, **kw)


def _bloom(**kw) -> ModelConfig:
    return ModelConfig(family="bloom", vocab_size=250880, positions="alibi",
                       norm="ln", act="gelu", embed_layer_norm=True, **kw)


PRESETS: dict[str, ModelConfig] = {
    # --- OPT family (opt.py) ---
    "opt-125m": _opt(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
    "opt-350m": _opt(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                     embed_proj_dim=512, do_layer_norm_before=False),
    "opt-1.3b": _opt(d_model=2048, n_layers=24, n_heads=32, d_ff=8192),
    "opt-2.7b": _opt(d_model=2560, n_layers=32, n_heads=32, d_ff=10240),
    "opt-6.7b": _opt(d_model=4096, n_layers=32, n_heads=32, d_ff=16384),
    "opt-13b": _opt(d_model=5120, n_layers=40, n_heads=40, d_ff=20480),
    "opt-30b": _opt(d_model=7168, n_layers=48, n_heads=56, d_ff=28672),
    "opt-66b": _opt(d_model=9216, n_layers=64, n_heads=72, d_ff=36864),
    # --- Llama-2 family (llama.py) ---
    "llama-2-7b": _llama(d_model=4096, n_layers=32, n_heads=32, d_ff=11008),
    "llama-2-13b": _llama(d_model=5120, n_layers=40, n_heads=40, d_ff=13824),
    "llama-2-70b": _llama(d_model=8192, n_layers=80, n_heads=64,
                          n_kv_heads=8, d_ff=28672),
    # --- BLOOM family (zeroShot/models/bloom.py) ---
    "bloom-560m": _bloom(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
    "bloom-1b7": _bloom(d_model=2048, n_layers=24, n_heads=16, d_ff=8192),
    "bloom-7b1": _bloom(d_model=4096, n_layers=30, n_heads=32, d_ff=16384),
    # --- tiny configs for tests/benchmarks ---
    "opt-tiny": _opt(vocab=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     max_seq=128),
    "llama-tiny": ModelConfig(
        family="llama", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        d_ff=128, positions="rope", norm="rms", act="silu_glu",
        tie_word_embeddings=False, attn_bias=False, mlp_bias=False,
        max_seq=128),
    "bloom-tiny": ModelConfig(
        family="bloom", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        d_ff=128, positions="alibi", norm="ln", act="gelu",
        embed_layer_norm=True, max_seq=128),
}


def get_config(name: str) -> ModelConfig:
    """Resolve a model name ('facebook/opt-125m', 'opt-125m', ...)."""
    key = name.lower().split("/")[-1]
    key = key.replace("meta-llama-", "llama-").replace("bigscience-", "")
    if key in PRESETS:
        return PRESETS[key]
    raise KeyError(f"unknown model {name!r}; known: {sorted(PRESETS)}")
