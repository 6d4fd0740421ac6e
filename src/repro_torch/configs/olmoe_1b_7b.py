"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060]
(port of ``repro/configs/olmoe_1b_7b.py``; the analytic counts of the model zoo
read it, the port serves no model of it yet).

16L d_model=2048, 16 heads (GQA kv=16 == MHA), per-expert d_ff=1024,
vocab=50304, MoE on every layer.  long_500k: SKIPPED — full-attention MoE,
4k-context model card (DESIGN.md §Arch-applicability).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    vocab_size=50304,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    act="swiglu",
    n_experts=64,
    experts_per_token=8,
    rope_theta=10000.0,
    source="arXiv:2409.02060 (OLMoE), allenai/OLMoE-1B-7B-0924",
)

REDUCED = ModelConfig(
    name="olmoe-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    act="swiglu",
    n_experts=4,
    experts_per_token=2,
    source="reduced smoke variant",
)
