"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

Copy of `repro.configs.gemma3_12b`: 48L, d_model=3840, 16H (GQA kv=8),
head_dim 256, d_ff=15360, vocab=262144. Pattern: 5 local
(sliding-window 1024) layers per 1 global layer.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,           # gemma3 uses head_dim 256 (> d_model/heads)
        d_ff=15360,
        vocab=262144,
        qk_norm=True,
        local_global=(5, 1, 1024),
        rope_base=1_000_000.0,
        source="hf:google/gemma-3-12b-pt",
    )
