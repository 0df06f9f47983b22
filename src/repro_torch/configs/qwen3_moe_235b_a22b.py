"""Qwen3-MoE 235B-A22B (hf:Qwen/Qwen3-30B-A3B family scaling; hf-verified
family). 94L, d=4096, 64 q heads (GQA kv=4), 128 experts top-8,
per-expert hidden 1536, vocab 151936. head_dim=128 per the Qwen3 family.
"""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=0, d_expert=1536, n_experts=128, top_k=8,
    vocab=151936, head_dim=128, rope_theta=1000000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=8, top_k=2, d_expert=32, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
