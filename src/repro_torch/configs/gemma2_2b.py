"""gemma2-2b [arXiv:2408.00118].

26 layers alternating local (sliding-window 4096) / global attention,
d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216, vocab=256000.
Logit softcap 30, attention softcap 50, (1+w) RMSNorm, post-block norms,
tied embeddings scaled by sqrt(d).  long_500k runs with global layers
falling back to an 8192 window (DESIGN.md §Arch-applicability).
"""
from repro_torch.core.config import ModelConfig, register_arch


@register_arch("gemma2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        act="gelu",
        attn_softcap=50.0,
        logit_softcap=30.0,
        sliding_window=4096,
        local_global_interval=2,
        post_block_norms=True,
        rms_plus_one=True,
        tie_embeddings=True,
        long_context_window=8192,
        source="arXiv:2408.00118",
    )
