"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]
(port of ``repro/configs/llama32_1b.py``).

16L d_model=2048, 32 heads (GQA kv=8, head_dim=64), d_ff=8192,
vocab=128256.
``LONG_CONTEXT_VARIANT`` is the reference's: the same model with a sliding
window of 8192 (``-swa8k``).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    vocab_size=128256,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    act="swiglu",
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-1B (+ arXiv:2407.21783)",
)

LONG_CONTEXT_VARIANT = dataclasses.replace(
    CONFIG, name=CONFIG.name + "-swa8k", sliding_window=8192
)

REDUCED = ModelConfig(
    name="llama32-1b-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    act="swiglu",
    rope_theta=500000.0,
    source="reduced smoke variant",
)
