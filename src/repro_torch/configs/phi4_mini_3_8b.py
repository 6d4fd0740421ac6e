"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905]
(port of ``repro/configs/phi4_mini_3_8b.py``; the analytic counts of the model zoo
read it, and the port serves it).

32L d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064.
long_500k: runs via the sliding-window variant (window 8192) — explicitly
a variant config, not the model card's context claim
(DESIGN.md §Arch-applicability).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    vocab_size=200064,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    act="swiglu",
    rope_theta=10000.0,
    source="arXiv:2412.08905 (Phi-4), microsoft/Phi-4-mini-instruct",
)

LONG_CONTEXT_VARIANT = dataclasses.replace(
    CONFIG, name=CONFIG.name + "-swa8k", sliding_window=8192
)

REDUCED = ModelConfig(
    name="phi4-mini-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    act="swiglu",
    source="reduced smoke variant",
)
