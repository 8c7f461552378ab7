"""grok-1-314b [hf:xai-org/grok-1].

64 layers, d_model=6144, 48 heads (GQA kv=8), MoE with 8 experts / top-2,
expert d_ff=32768, vocab=131072.  Attention and final logits use tanh
softcaps (30.0) per the released implementation.  Experts are sharded in
"tensor" mode (ff dim over the model axis) since 8 experts < 16-way axis.
"""
from repro_torch.core.config import ModelConfig, MoEConfig, register_arch


@register_arch("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        attn_softcap=30.0,
        logit_softcap=30.0,
        act="gelu",
        moe=MoEConfig(num_experts=8, num_experts_per_token=2,
                      d_ff_expert=32768, shard_mode="tensor"),
        source="hf:xai-org/grok-1",
    )
