from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          make_optimizer, momentum, sgd)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "adam", "apply_updates", "make_optimizer",
           "momentum", "sgd", "constant", "cosine_decay", "warmup_cosine"]
