"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295]
(port of ``repro/configs/gemma_7b.py``; the analytic counts of the model zoo
read it, the port serves no model of it yet).

28L d_model=3072, 16 heads (kv=16 == MHA; MQA is on the 2b variant),
head_dim=256 (q/k/v project 3072 -> 4096), d_ff=24576 (GeGLU),
vocab=256000.  long_500k: runs via the sliding-window variant (window
8192) — a variant config (DESIGN.md §Arch-applicability).
The reference's ``LONG_CONTEXT_VARIANT`` waits for the sliding mask
(ROADMAP).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    vocab_size=256000,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    act="geglu",
    rope_theta=10000.0,
    source="arXiv:2403.08295 (Gemma), google/gemma-7b",
)

REDUCED = ModelConfig(
    name="gemma-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    act="geglu",
    source="reduced smoke variant",
)
