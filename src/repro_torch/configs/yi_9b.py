"""yi-9b [dense] — llama-arch GQA kv=4 [arXiv:2403.04652]
(port of ``repro/configs/yi_9b.py``; the analytic counts of the model zoo
read it, and the port serves it).

48L d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
Sharding note: 4 kv heads < 16-way model axis -> kv projections stay
replicated under TP (standard GQA practice).  long_500k: runs via the
sliding-window variant (window 8192) (DESIGN.md §Arch-applicability).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    vocab_size=64000,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    act="swiglu",
    rope_theta=10000.0,
    source="arXiv:2403.04652 (Yi), 01-ai/Yi-9B",
)

LONG_CONTEXT_VARIANT = dataclasses.replace(
    CONFIG, name=CONFIG.name + "-swa8k", sliding_window=8192
)

REDUCED = ModelConfig(
    name="yi-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    act="swiglu",
    source="reduced smoke variant",
)
