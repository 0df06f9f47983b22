"""Kimi K2 — trillion-parameter MoE (arXiv:2501.kimi2; paper-table,
unverified). 61L, d=7168, 64 q heads (GQA kv=8), 384 experts top-8,
per-expert FFN hidden 2048, vocab 163840.

Assumptions (fields the assignment doesn't pin): head_dim = d/H = 112,
rope_theta = 50000, one shared expert (common for fine-grained MoE;
excluded here — assignment lists pure 384e top-8), untied embeddings.
"""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=0, d_expert=2048, n_experts=384, top_k=8,
    vocab=163840, head_dim=112, rope_theta=50000.0,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2501.kimi2; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=8, top_k=2, d_expert=32, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
