"""Architecture, input-shape and protocol configuration: copies of
`repro.configs.base.MoEConfig`, `SSMConfig`, `ArchConfig`, `ShapeConfig`
and `ProtocolConfig` (fields, properties and `reduced()` unchanged), so a config built here equals the JAX package's
field for field. `MeshConfig` belongs to the GSPMD planner, which the
port does not have."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int            # per-expert hidden size
    capacity_factor: float = 1.25
    group_size: int = 2048
    dispatch: str = "einsum"    # "einsum" (GShard baseline) | "sort" (lean)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_base: float = 10000.0
    # Sliding-window attention: window for ALL attention layers...
    window: Optional[int] = None
    # ...or a local:global pattern (n_local, n_global, local_window).
    local_global: Optional[Tuple[int, int, int]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): number of SSM blocks between shared-attention calls.
    attn_every: Optional[int] = None
    # encdec (whisper): encoder depth (n_layers counts DECODER layers).
    n_enc_layers: int = 0
    enc_seq: int = 1500          # whisper: 30 s audio -> 1500 frames
    # vlm (llama-3.2-vision): a cross-attn layer after every N self layers.
    cross_attn_every: Optional[int] = None
    n_image_tokens: int = 1600
    # GAN heads
    d_z: int = 128               # generator noise channel dim
    # Discriminator depth (None -> same as generator). The paper's devices
    # hold whole discriminators; for the >=40B backbones a full-depth local
    # replica cannot fit one device-group's HBM, so the local discriminator
    # is a shallower stack of the same family (DESIGN.md §Changed-assumptions).
    disc_layers: Optional[int] = None
    norm_eps: float = 1e-6
    use_attn_bias: bool = False  # whisper uses biases
    # flash path lays kv-heads on the TP axis by repeating k/v to full
    # heads (useful when n_kv_heads doesn't divide the model axis)
    flash_repeat_kv: bool = False
    # fused qkv / in+gate projections: one matmul + ONE dx all-reduce in
    # the TP backward instead of 3 (qkv) / 2 (in,gate) — §Perf lever
    fuse_proj: bool = False
    tie_embeddings: bool = False
    source: str = ""             # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    # ----- layer grouping for scan-over-layers ---------------------------
    @property
    def group_pattern(self) -> Tuple[str, ...]:
        """Sublayer kinds of one repeated group."""
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "hybrid":
            assert self.attn_every
            return ("ssm",) * self.attn_every + ("shared_attn",)
        if self.family == "vlm":
            assert self.cross_attn_every
            return ("attn",) * self.cross_attn_every + ("cross",)
        if self.family == "encdec":
            return ("attn", "cross")   # each decoder layer self+cross attends
        if self.local_global is not None:
            n_local, n_global, _ = self.local_global
            return ("attn_local",) * n_local + ("attn_global",) * n_global
        return ("attn",)

    @property
    def n_groups_stack(self) -> int:
        pat = self.group_pattern
        per_group = sum(1 for kind in pat if kind != "cross")
        if self.family == "vlm":
            # n_layers counts self+cross layers together (100 = 80 self + 20 cross)
            per_group = len(pat)
        if self.family == "hybrid":
            # n_layers counts SSM blocks; shared attention is extra
            per_group = self.attn_every
        assert self.n_layers % per_group == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by group of {per_group}"
        return self.n_layers // per_group

    def sublayer_window(self, kind: str) -> Optional[int]:
        if kind == "attn_local":
            return self.local_global[2]
        if kind == "attn_global":
            return None
        return self.window

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family."""
        pat_len = len(self.group_pattern)
        if self.family == "vlm":
            layers = pat_len          # one group
        elif self.family == "hybrid":
            layers = self.attn_every  # one group (+1 shared attn)
        elif self.local_global is not None:
            layers = pat_len          # one local:global group
        else:
            layers = 2
        d_model = min(self.d_model, 256)
        head_dim = 32
        n_heads = max(2, min(self.n_heads, d_model // head_dim))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        changes = dict(
            n_layers=layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=head_dim,
            d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 512),
            d_z=32, n_enc_layers=min(self.n_enc_layers, 2), enc_seq=16,
            n_image_tokens=8,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128), group_size=64)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16),
                head_dim=32, chunk=16)
        if self.local_global is not None:
            changes["local_global"] = (self.local_global[0],
                                       self.local_global[1], 8)
        if self.window is not None:
            changes["window"] = min(self.window, 8)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


# The JAX package's input shapes, which the dry run sizes every
# architecture at (`launch.dryrun`).
INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """The paper's training-protocol knobs (Section III, Section IV)."""
    n_devices: int = 10          # K
    n_d: int = 5                 # local discriminator steps (Algorithm 1)
    n_g: int = 5                 # server generator steps (Algorithm 3)
    sample_size: int = 128       # m_k
    server_sample_size: int = 128  # M
    lr_d: float = 2e-4           # eta_d
    lr_g: float = 2e-4           # eta_g
    schedule: str = "serial"     # "serial" | "parallel"
    # Gradient-accumulation microbatch sizes (None = whole sample batch in
    # one fwd/bwd); FedGAN takes none, as in the JAX package.
    micro_batch_d: Optional[int] = None
    micro_batch_g: Optional[int] = None
    # The shared-seed design makes every device's fake batch identical;
    # the port always computes it once per local step, so both values
    # give the same math.
    hoist_fakes: bool = False
    scheduler: str = "all"       # "all" | "round_robin" | "best_channel" | "prop_fair"
    scheduling_ratio: float = 1.0
    quantize_bits: int = 16      # uplink quantization (paper: 16 bit)
    optimizer: str = "sgd"       # paper uses plain mini-batch SGD
