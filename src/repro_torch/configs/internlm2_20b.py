"""internlm2-20b [arXiv:2403.17297].

48 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92544.
Llama-like: RMSNorm, RoPE (theta 1e6), gated silu MLP.
"""
from repro_torch.core.config import ModelConfig, register_arch


@register_arch("internlm2-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1000000.0,
        source="arXiv:2403.17297",
    )
