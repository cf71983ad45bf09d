from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          make_optimizer, momentum, sgd)

__all__ = ["Optimizer", "adam", "apply_updates", "make_optimizer",
           "momentum", "sgd"]
