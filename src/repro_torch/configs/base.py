"""Config system: model architecture + parallelism + run shapes
(``repro.configs.base``).

Every architecture gets a ``configs/<id>.py`` exporting
``CONFIG: ArchConfig`` (the exact published hyperparameters) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  The
dataclasses, shapes and names are the reference's, so one config means
the same model in both packages.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention; >0 = window (ring cache)
    mlp_gated: bool = True          # SwiGLU if True, GELU-MLP otherwise
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_aux_loss: float = 0.01      # router load-balance loss weight
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0              # mamba2 d_state
    ssm_conv: int = 4               # mamba2 depthwise conv width
    ssm_expand: int = 2             # mamba2 inner expansion
    ssm_head_dim: int = 64          # mamba2/rwkv head dim
    chunk_size: int = 128           # chunked-scan length for ssm/rwkv
    # hybrid (zamba2): mamba backbone + ONE shared attention block applied
    # every `attn_every` mamba layers (parameters shared across applications)
    attn_every: int = 0
    # encoder-decoder (seamless): encoder layers with cross-attention decoder
    encoder_layers: int = 0
    # multimodal stub frontends: prefix embeddings prepended to token embeds
    num_prefix_tokens: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act_dtype: str = "float32"      # activation dtype ("bfloat16" in prod configs)
    q_chunk: int = 1024             # query-chunk size for long-seq attention

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab dim shards over
        any model axis up to 256 (Megatron-style padding; pad logits are
        masked to -inf in the LM head).  256206 -> 256256 for seamless."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.arch_type == "ssm":  # rwkv6
            per = 2 * d * d + 2 * d * (d // 2) + 3 * d * f // 2  # rough: time+channel mix
            per = 4 * d * d + 2 * d * f
            return emb + L * per
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.num_experts:
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        else:
            mlp = (3 if self.mlp_gated else 2) * d * f
        if self.arch_type == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d \
                + d_in * (self.ssm_conv + 3)
            n_attn_applications = 0  # shared params counted once
            return emb + L * (mamba) + attn + (3 * d * f)
        per = attn + mlp
        total = emb + L * per
        if self.encoder_layers:
            total += self.encoder_layers * per + L * attn  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses routed experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        full = self.param_count()
        all_experts = L * self.num_experts * 3 * d * f
        active = L * self.experts_per_tok * 3 * d * f
        return full - all_experts + active


# ---------------------------------------------------------------------------
# Parallelism / run configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = False          # shard params over the data axis + per-layer gather
    microbatches: int = 1       # gradient-accumulation steps inside train_step
    aggregation: str = "rs_mm"  # mean | gather_mm | rs_mm | hier_mm
    use_kernel: bool = False    # Pallas MM kernel inside the aggregation
    remat: bool = True          # per-layer activation checkpointing
    agg_num_iters: int = 10
    opt_state_dtype: str = "float32"  # adam m/v storage dtype


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    parallel: ParallelConfig = ParallelConfig()
    # per input-shape overrides, keyed by shape name
    overrides: Tuple[Tuple[str, ParallelConfig], ...] = ()

    def parallel_for(self, shape_name: str) -> ParallelConfig:
        for k, v in self.overrides:
            if k == shape_name:
                return v
        return self.parallel


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = (
    "seamless_m4t_large_v2",
    "zamba2_2p7b",
    "qwen1p5_110b",
    "rwkv6_1p6b",
    "qwen3_0p6b",
    "qwen3_32b",
    "qwen3_moe_235b_a22b",
    "dbrx_132b",
    "stablelm_3b",
    "llava_next_34b",
)

# CLI-facing ids (match the assignment sheet)
ARCH_ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen1.5-110b": "qwen1p5_110b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "qwen3-0.6b": "qwen3_0p6b",
    "qwen3-32b": "qwen3_32b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "dbrx-132b": "dbrx_132b",
    "stablelm-3b": "stablelm_3b",
    "llava-next-34b": "llava_next_34b",
}


def resolve_arch(name: str) -> str:
    key = ARCH_ALIASES.get(name, name)
    if key not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(ARCH_ALIASES)}")
    return key


def load_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve_arch(name)}")
    return mod.CONFIG


def load_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve_arch(name)}")
    return mod.smoke_config()
