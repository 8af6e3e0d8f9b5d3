"""Architecture and shape configuration dataclasses (the counterpart of
``repro.configs.base``). Pure data: ``input_specs``, which builds the JAX
dry-run's ``ShapeDtypeStruct`` stand-ins, comes with the dry-run."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture. Families: dense | moe | ssm | hybrid |
    audio (enc-dec) | vlm."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_layer_dense: bool = False
    dense_d_ff: int = 0
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_period: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    dec_len: int = 448
    # vlm (qwen2-vl)
    vision_patches: int = 0
    mrope: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Supports the long_500k cell (decode cost independent of context)."""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell, with a reason when not.

    long_500k needs sub-quadratic attention: run for SSM/hybrid, skip for
    pure full-attention archs (noted in DESIGN.md)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "full-attention arch: 500k decode KV cache/attention is " \
                      "quadratic-cost; cell assigned to SSM/hybrid archs only"
    return True, ""

