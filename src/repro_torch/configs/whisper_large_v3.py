"""Whisper-large-v3 (arXiv:2212.04356; unverified). Enc-dec: 32+32L,
d=1280, 20H (MHA kv=20), ff=5120, vocab=51866 (padded 51968);
LayerNorm + GELU, sinusoidal positions, conv/mel frontend STUBBED
(input_specs provides precomputed frame embeddings, 1500 frames = 30 s).
"""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, n_dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    norm="layernorm", mlp="gelu", attn_bias=True,
    max_source_len=1500,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.replace(
    n_layers=2, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, max_source_len=32,
    param_dtype=torch.float32, compute_dtype=torch.float32)
