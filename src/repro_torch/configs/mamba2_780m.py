"""mamba2-780m [ssm]: attention-free SSD. [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, head_dim=64,
)
