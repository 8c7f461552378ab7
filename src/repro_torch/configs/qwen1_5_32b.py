"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B family].

64 layers, d_model=5120, 40 heads (kv=40, MHA), d_ff=27392, vocab=152064.
QKV bias (the fused bias+act epilogue is exactly the paper's FC technique).
40 heads are not divisible by the 16-way model axis; the auto sharding
rules replicate attention heads and shard only the MLP (a head-padding
variant is evaluated in EXPERIMENTS.md SPerf).
"""
from repro_torch.core.config import ModelConfig, register_arch


@register_arch("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        use_qkv_bias=True,
        rope_theta=1000000.0,
        source="hf:Qwen/Qwen1.5-0.5B (scaled per 32B card)",
    )
