"""Assigned input-shape set (same four for every LM arch).

``kind`` selects what gets lowered: train_step for training shapes,
serve prefill/decode for inference shapes (decode_* / long_* lower
``serve_step`` — one new token against a seq_len KV cache).
"""

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid
# families; pure full-attention archs skip it (DESIGN.md §Arch-applicability)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg) -> dict:
    out = dict(SHAPES)
    if cfg.family not in LONG_OK_FAMILIES:
        out.pop("long_500k")
    return out
