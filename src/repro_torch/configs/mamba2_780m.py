"""Mamba2-780m (arXiv:2405.21060; unverified). Attention-free SSD:
48L, d=1536, d_state=128, expand=2 (d_inner=3072), ssd head_dim=64
(48 heads), conv=4, vocab=50280 (padded to 50432), tied embeddings."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=128,
    norm="rmsnorm", tie_embeddings=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2405.21060; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
