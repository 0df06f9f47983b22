"""MiniCPM-2B (arXiv:2404.06395; hf-verified). Llama-like: 40L, d=2304,
36H (MHA kv=36), ff=5760, vocab=122753 (padded to 122880 for sharding),
tied embeddings. Trains with the WSD schedule (train config default)."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64, rope_theta=10000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2404.06395; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
