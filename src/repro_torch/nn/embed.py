"""Token embedding table."""
from __future__ import annotations

import torch

from repro_torch.nn import initializers


def embedding_init(generator: torch.Generator, vocab: int, d: int):
    return {"table": initializers.normal(generator, (vocab, d), stddev=0.02)}


def embedding_apply(params, token_ids):
    """Rows of the table at integer `token_ids` (any shape)."""
    if token_ids.is_floating_point():
        raise TypeError(f"token ids must be integers, not {token_ids.dtype}")
    return params["table"][token_ids]
