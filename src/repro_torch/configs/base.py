"""Protocol configuration (copy of `repro.configs.base.ProtocolConfig`)."""
from __future__ import annotations

import dataclasses
from typing import Optional


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
    # one fwd/bwd). The port does not support microbatching yet.
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
