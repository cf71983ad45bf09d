"""whisper-base [audio] — encoder-decoder, conv frontend (stub)
[arXiv:2212.04356].

Copy of `repro.configs.whisper_base`: 6 decoder and 6 encoder layers,
d_model=512, 8H (kv=8), d_ff=2048, vocab=51865, LayerNorm and biased
projections. The mel-spectrogram and conv feature extractor is a stub:
the encoder takes precomputed frame embeddings (b, enc_seq, d_model)
(`models.specs.make_stub_enc_feats`). Positions use RoPE instead of
Whisper's absolute embeddings, as in the JAX package.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,              # decoder layers
        n_enc_layers=6,
        enc_seq=1500,            # 30 s of audio at 50 Hz after the conv stub
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        use_attn_bias=True,
        source="arXiv:2212.04356 (Whisper)",
    )
