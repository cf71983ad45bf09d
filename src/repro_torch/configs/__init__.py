from repro_torch.configs.base import ProtocolConfig
from repro_torch.configs.dcgan import DCGANConfig

__all__ = ["ProtocolConfig", "DCGANConfig"]
