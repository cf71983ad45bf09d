"""llama-3.2-vision-90b [vlm] — gated cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision family].

Copy of `repro.configs.llama_3_2_vision_90b`: 100 layers (80
self-attention + 20 gated cross-attention, one after every 4 self
layers), d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256. The
ViT vision encoder and projector are a stub: the cross layers take
precomputed patch embeddings (b, n_image_tokens, d_model)
(`models.specs.make_stub_enc_feats`).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,            # 80 self + 20 cross
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        cross_attn_every=4,
        disc_layers=10,         # 2 groups
        n_image_tokens=1600,
        rope_base=500_000.0,
        source="hf:meta-llama/Llama-3.2-90B-Vision",
    )
