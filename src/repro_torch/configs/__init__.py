"""Architecture registry: ``--arch <id>`` selects one of the 10 assigned
configs (the counterpart of ``repro.configs``; the fields are the same, a
test holds every one against it)."""
from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      cell_applicable)

from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.internlm2_1p8b import CONFIG as _internlm2
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl

ARCHS = {c.name: c for c in [
    _zamba2, _mamba2, _deepseek, _granite, _nemo,
    _llama3, _internlm2, _phi3, _whisper, _qwen2vl,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def smoke_config(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab=256)
    if arch.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=32,
                  n_shared_experts=arch.n_shared_experts and 1, dense_d_ff=128)
    if arch.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, n_heads=4, n_kv_heads=4)
    if arch.family == "hybrid":
        kw.update(n_layers=4, shared_attn_period=2)
    if arch.family == "audio":
        kw.update(n_enc_layers=2, dec_len=16, n_kv_heads=4)
    if arch.family == "vlm":
        kw.update(vision_patches=16, n_kv_heads=2, n_heads=4, head_dim=16)
    return arch.scaled(**kw)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_arch",
           "get_shape", "cell_applicable", "smoke_config"]
