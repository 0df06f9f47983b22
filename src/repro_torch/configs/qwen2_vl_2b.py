"""Qwen2-VL-2B (arXiv:2409.12191; hf-verified). 28L, d=1536, 12H
(GQA kv=2), ff=8960, vocab=151936; M-RoPE sections (16, 24, 24) over
head_dim/2 = 64 pairs; attention biases; tied embeddings.

The vision frontend (ViT patch encoder, dynamic resolution) is a STUB:
input_specs() supplies precomputed patch/frame embeddings plus the 3-D
M-RoPE position ids the frontend would emit.
"""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm", mlp="swiglu", attn_bias=True, tie_embeddings=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2409.12191; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, mrope_sections=(2, 3, 3),
    param_dtype=torch.float32, compute_dtype=torch.float32)
