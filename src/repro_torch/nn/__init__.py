from repro_torch.nn.attention import (attention_apply, attention_init,
                                      attention_kv)
from repro_torch.nn.conv import (conv2d_apply, conv2d_init,
                                 conv_transpose2d_apply,
                                 conv_transpose2d_init)
from repro_torch.nn.embed import embedding_apply, embedding_init
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norms import (batchnorm_apply, batchnorm_init,
                                  layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.rope import apply_rope, rope_frequencies
from repro_torch.nn.ssm import (ssd_mixer_apply, ssd_mixer_init,
                                ssd_scan_ref)

__all__ = ["attention_apply", "attention_init", "attention_kv",
           "apply_rope", "conv2d_apply", "conv2d_init",
           "conv_transpose2d_apply", "conv_transpose2d_init",
           "embedding_apply", "embedding_init", "batchnorm_apply",
           "batchnorm_init", "layernorm_apply", "layernorm_init",
           "mlp_apply", "mlp_init", "moe_apply", "moe_init",
           "rmsnorm_apply", "rmsnorm_init", "rope_frequencies",
           "ssd_mixer_apply", "ssd_mixer_init", "ssd_scan_ref"]
