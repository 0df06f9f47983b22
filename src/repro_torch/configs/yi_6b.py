"""Yi-6B (arXiv:2403.04652; hf-verified). Llama-arch GQA: 32L, d=4096,
32H (kv=4), ff=11008, vocab=64000, rope_theta=5e6."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5000000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2403.04652; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
