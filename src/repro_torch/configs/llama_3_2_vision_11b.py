"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision].

40-layer language decoder, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=128256; gated cross-attention image layers every 5th layer.  The ViT
vision tower is stubbed per the assignment carve-out: ``input_specs``
provides 4096-dim patch embeddings (1601 patches x up to 4 tiles ~ 6404,
rounded to 6400).
"""
from repro_torch.core.config import ModelConfig, CrossAttnConfig, register_arch


@register_arch("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        act="silu",
        cross_attn=CrossAttnConfig(interval=5, num_media_tokens=6400,
                                   media_dim=4096),
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
