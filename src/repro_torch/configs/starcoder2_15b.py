"""StarCoder2-15B (arXiv:2402.19173; hf-verified). 40L, d=6144,
48H (GQA kv=4), ff=24576, vocab=49152; LayerNorm + GELU, attention
biases, rope_theta=100000."""
import torch

from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128, rope_theta=100000.0,
    norm="layernorm", mlp="gelu", attn_bias=True, tie_embeddings=False,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    source="arXiv:2402.19173; hf",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    param_dtype=torch.float32, compute_dtype=torch.float32)
