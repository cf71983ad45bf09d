from repro_torch.core.engine import RoundRecord, Trainer

__all__ = ["RoundRecord", "Trainer"]
