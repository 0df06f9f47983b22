"""Llama-3.1 405B (arXiv:2407.21783; unverified). 126L, d=16384,
128H (GQA kv=8), ff=53248, vocab=128256, rope_theta=500000."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, head_dim=128, rope_theta=500000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2407.21783; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
