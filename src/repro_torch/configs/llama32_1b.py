"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]
(port of ``repro/configs/llama32_1b.py``).

16L d_model=2048, 32 heads (GQA kv=8, head_dim=64), d_ff=8192,
vocab=128256.  The reference's ``LONG_CONTEXT_VARIANT`` (sliding window
8192) waits for the sliding mask (ROADMAP).
"""

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
