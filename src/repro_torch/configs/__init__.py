"""The language-model architectures, one module per ``--arch`` id (copies
of ``repro.configs``' plain data).  Importing this package registers them
with ``repro_torch.core.config``."""
from repro_torch.configs import (  # noqa: F401
    llama_3_2_vision_11b,
    seamless_m4t_large_v2,
    grok_1_314b,
    gemma2_2b,
    rwkv6_1_6b,
    starcoder2_15b,
    internlm2_20b,
    qwen1_5_32b,
    zamba2_1_2b,
    qwen3_moe_30b_a3b,
)
