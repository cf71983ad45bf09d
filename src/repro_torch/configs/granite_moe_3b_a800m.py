"""granite-moe-3b-a800m [moe] — fine-grained MoE, top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base].

Copy of `repro.configs.granite_moe_3b_a800m`: 32L, d_model=1536, 24H
(GQA kv=8), d_ff=512 (per expert), vocab=49155, MoE 40 experts top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                      group_size=1024),
        source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    )
