"""zamba2-1.2b [arXiv:2411.15242].

38 Mamba2 blocks (d_model=2048, ssm_state=64) + one shared attention block
(32 heads, kv=32, head_dim=128 at concat width 4096, d_ff=8192) applied
every 6 blocks, vocab=32000.  Hybrid: long_500k runs natively with the
shared attention using a 4096 sliding window in long-context mode.
"""
from repro_torch.core.config import ModelConfig, SSMConfig, register_arch


@register_arch("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=8192,
        vocab_size=32000,
        shared_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        long_context_window=4096,
        source="arXiv:2411.15242",
    )
