"""Model configuration: the port's copy of ``repro.core.config``.

Every architecture is a frozen :class:`ModelConfig`; the modules of
``repro_torch.configs`` register themselves on import, as in the JAX
package, as are its input shapes (:class:`ShapeConfig`, ``SHAPES``), its
meshes (:class:`MeshConfig`: the JAX package's two pods, and a node of
cards is just another ``MeshConfig((1, 4), ("data", "model"))``) and its
training configuration.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    num_experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25  # training (drops are a gradient tradeoff)
    eval_capacity_factor: float = 2.0  # prefill (rare drops tolerated)
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # "expert": shard the expert dimension over the model axis (many small
    # experts, e.g. qwen3's 128).  "tensor": shard each expert's ff dimension
    # over the model axis (few large experts, e.g. grok's 8).
    shard_mode: str = "expert"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD state-space block configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time/channel mixing configuration."""

    head_dim: int = 64
    decay_lora: int = 64
    tokenshift_lora: int = 32
    chunk_size: int = 64  # [b,L,L,h,e] pairwise-decay transient stays <1GB


@dataclass(frozen=True)
class CrossAttnConfig:
    """Cross-attention (VLM / encoder-decoder) configuration."""

    # every `interval`-th layer is a cross-attention layer (VLM style);
    # 0 means "every decoder layer has cross-attention" (enc-dec style).
    interval: int = 0
    num_media_tokens: int = 0  # stub frontend: number of patch/frame embeds
    media_dim: int = 0  # embedding dim delivered by the (stubbed) frontend


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` is one of dense | moe | ssm | hybrid | vlm | audio.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    source: str = ""  # citation for the config

    # --- attention variants -------------------------------------------------
    rope_theta: float = 10000.0
    use_qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0  # gemma2 final-logit softcap (0 = off)
    attn_softcap: float = 0.0  # gemma2 attention-logit softcap (0 = off)
    sliding_window: int = 0  # 0 = full attention
    # gemma2-style alternation: 0 = uniform; k>0 = every k-th layer is
    # global, the rest use `sliding_window`.
    local_global_interval: int = 0
    # post-attn / post-mlp extra norms (gemma2)
    post_block_norms: bool = False
    tie_embeddings: bool = False
    attn_logit_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    attn_chunk: int = 512  # flash chunk size (K/V re-read factor ~ s/chunk)

    # --- non-attention mixers ----------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None

    # --- hybrid (zamba2): shared attention block applied every k ssm blocks
    shared_attn_every: int = 0

    # --- encoder/decoder (audio) --------------------------------------------
    num_encoder_layers: int = 0  # >0 => encoder-decoder model

    # --- long-context fallback ----------------------------------------------
    # Window used when a full-attention arch is run on the long_500k shape
    # ("sliding-window variant", documented in DESIGN.md §Arch-applicability).
    long_context_window: int = 8192

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # int8 KV cache with per-(slot, head) scales.  The scales factor exactly
    # into the score/prob vectors (s = (q·k_i8)·scale; pv = (p·v_scale)·v_i8)
    # so the int8 tensors are only ever operands of MXU dots.  Auto-enabled
    # by the dry-run when the bf16 cache would exceed ~8 GB/device.
    kv_quant: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"  # mlp activation: silu | gelu | relu
    mlp_gated: bool = True  # SwiGLU/GeGLU vs plain 2-matrix MLP
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    rms_plus_one: bool = False  # gemma (1+w) convention

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived -------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (TPU lane width; also makes
        every assigned vocab divisible by the 16-way model axis)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        """Parameter count of the port's model (every family)."""
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self)

    def active_params(self) -> int:
        """Parameters a token meets: an MoE model's experts at k of E."""
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 layers,
        d_model<=512, <=4 experts)."""
        changes: Dict[str, Any] = dict(
            num_layers=2,
            d_model=256,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=64,
            d_ff=512,
            vocab_size=512,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                num_experts_per_token=min(2, self.moe.num_experts_per_token),
                d_ff_expert=128,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, d_state=16, chunk_size=32)
        if self.rwkv is not None:
            changes["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=64, decay_lora=16, tokenshift_lora=8, chunk_size=32
            )
        if self.cross_attn is not None:
            changes["cross_attn"] = dataclasses.replace(
                self.cross_attn,
                interval=min(self.cross_attn.interval, 2),
                num_media_tokens=16,
                media_dim=256,
            )
        if self.num_encoder_layers:
            changes["num_encoder_layers"] = 2
        if self.shared_attn_every:
            changes["shared_attn_every"] = 1
            changes["num_layers"] = 2
        if self.sliding_window:
            changes["sliding_window"] = 64
        if self.local_global_interval:
            changes["local_global_interval"] = 2
        changes["long_context_window"] = 64
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / distribution configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        return _prod(self.shape)

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes over which the batch is sharded."""
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def dp_size(self) -> int:
        return _prod(s for s, a in zip(self.shape, self.axes)
                     if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return _prod(s for s, a in zip(self.shape, self.axes) if a == "model")

    def size(self, axis: str) -> int:
        """The size of mesh axis ``axis`` (1 for an axis the mesh lacks)."""
        return dict(zip(self.axes, self.shape)).get(axis, 1)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
# CPU-sized meshes for tests.
TINY_MESH = MeshConfig((1, 1), ("data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    """AdamW and its schedule, the JAX package's ``TrainConfig``.  ``remat``
    is recorded (the models remat every layer unit in train mode, JAX's
    "full"); ``zero1`` too, for the optimizer's spec annotations, though
    the single-card trainer shards nothing."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # remat policy for the layer scan: "none" | "full" | "dots"
    remat: str = "full"
    zero1: bool = True  # shard optimizer state over the dp axes
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _ARCH_REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ModelConfig:
    _ensure_configs_imported()
    if name not in _ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ARCH_REGISTRY)}"
        )
    return _ARCH_REGISTRY[name]()


def list_archs():
    _ensure_configs_imported()
    return sorted(_ARCH_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def _ensure_configs_imported() -> None:
    import repro_torch.configs  # noqa: F401  (registers all archs)
