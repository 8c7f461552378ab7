"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B].

48 layers, d_model=2048, 32 heads (GQA kv=4, head_dim=128), MoE with 128
experts / top-8, expert d_ff=768, vocab=151936.  QK-norm per qwen3.
Experts shard in "expert" mode (128 experts over the 16-way model axis).
"""
from repro_torch.core.config import ModelConfig, MoEConfig, register_arch


@register_arch("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        moe=MoEConfig(num_experts=128, num_experts_per_token=8,
                      d_ff_expert=768, shard_mode="expert"),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
