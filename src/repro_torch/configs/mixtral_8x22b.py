"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

Copy of `repro.configs.mixtral_8x22b`: 56L, d_model=6144, 48H (GQA
kv=8), d_ff=16384, vocab=32768, MoE 8 experts top-2, sliding-window
attention of 4,096 keys.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        window=4096,
        rope_base=1_000_000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        disc_layers=8,          # a local discriminator of 8 layers
        source="arXiv:2401.04088 (Mixtral of Experts)",
    )
