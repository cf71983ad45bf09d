"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Copy of `repro.configs.mamba2_130m`: 24L, d_model=768, attention-free,
d_ff=0, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=24,          # d_inner / head_dim = 1536 / 64
        n_kv_heads=24,
        d_ff=0,              # attention-free, no separate FFN (assigned d_ff=0)
        vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
        source="arXiv:2405.21060 (Mamba-2 / SSD)",
    )
