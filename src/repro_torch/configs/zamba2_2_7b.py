"""zamba2-2.7b [hybrid] — Mamba-2 backbone + a shared attention block
[arXiv:2411.15242].

Copy of `repro.configs.zamba2_2_7b`: 54 Mamba-2 layers, d_model=2560,
32H (kv=32), d_ff=10240, vocab=32000, ssm_state=64. The one shared
attention + MLP block (a single parameter set) runs after every 6
Mamba-2 layers: 9 calls over 54 layers.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,            # Mamba-2 layers
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,          # multi-head attention in the shared block
        d_ff=10240,             # the shared block's MLP
        vocab=32000,
        attn_every=6,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
        source="arXiv:2411.15242 (Zamba2)",
    )
