"""Zamba2-2.7B (arXiv:2411.15242; hf-verified). Hybrid: 54 Mamba2 layers
(d_state=64) + ONE shared attention+MLP block (32H MHA, ff=10240)
applied every 6 SSM layers (9 applications, weights shared). d=2560,
vocab=32000, head_dim=80. Simplification noted in DESIGN.md: shared
block consumes the hidden state only (no embedding concat)."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80, rope_theta=10000.0,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=128, attn_every=6,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2411.15242; hf",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    attn_every=2,
    param_dtype=torch.float32, compute_dtype=torch.float32)
