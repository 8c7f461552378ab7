"""rwkv6-1.6b (Finch) [arXiv:2404.05892].

24 layers, d_model=2048, attention-free (WKV6 data-dependent decay,
64-wide heads), channel-mix d_ff=7168, vocab=65536.  O(1)-state decode;
long_500k runs natively (DESIGN.md §Arch-applicability).
"""
from repro_torch.core.config import ModelConfig, RWKVConfig, register_arch


@register_arch("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,          # 2048 / 64-wide WKV heads
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, tokenshift_lora=32),
        source="arXiv:2404.05892",
    )
