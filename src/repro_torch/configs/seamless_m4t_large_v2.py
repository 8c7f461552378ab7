"""seamless-m4t-large-v2 [arXiv:2308.11596].

Encoder-decoder multimodal backbone: 24 encoder + 24 decoder layers (model
card reading of "24L"), d_model=1024, 16 heads, d_ff=8192, vocab=256206
(padded to 256256 for the 16-way model axis).  The speech frontend
(mel + conv) is stubbed: ``input_specs`` provides 1024-dim frame embeddings
(4096 frames ~ 82s of 20ms-stride speech).
"""
from repro_torch.core.config import ModelConfig, CrossAttnConfig, register_arch


@register_arch("seamless-m4t-large-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        norm_kind="layernorm",
        act="gelu",
        mlp_gated=False,
        cross_attn=CrossAttnConfig(interval=0, num_media_tokens=4096,
                                   media_dim=1024),
        source="arXiv:2308.11596",
    )
