"""starcoder2-15b [arXiv:2402.19173].

40 layers, d_model=6144, 48 heads (GQA kv=4), d_ff=24576, vocab=49152.
RoPE theta 1e5, QKV bias, plain (non-gated) gelu MLP, native sliding
window 4096 -- long_500k runs with the native window.
"""
from repro_torch.core.config import ModelConfig, register_arch


@register_arch("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        rope_theta=100000.0,
        use_qkv_bias=True,
        mlp_gated=False,
        act="gelu",
        sliding_window=4096,
        norm_kind="layernorm",
        source="arXiv:2402.19173",
    )
