"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base] (port of
``repro/configs/arctic_480b.py``).

35L d_model=7168, 56 q-heads (GQA kv=8), MoE d_ff=4864 x 128 experts top-2,
dense-residual FFN in parallel with the MoE (Arctic's dense-MoE hybrid),
vocab=32000.

The reference pads the 56 q-heads to 64 so that its 16-way model axis
divides them (zero-init extra heads; their output-projection rows are zero
so they contribute nothing).  The port keeps the padded heads, so weights
carry across unchanged; the flash kernel then sees 64 heads a sequence.
long_500k: SKIPPED — full-attention 4k-context model card.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    vocab_size=32000,
    n_heads=56,
    padded_heads=64,
    n_kv_heads=8,
    d_ff=4864,       # dense-residual FFN width
    moe_d_ff=4864,   # per-expert FFN width
    act="swiglu",
    n_experts=128,
    experts_per_token=2,
    dense_residual=True,
    rope_theta=10000.0,
    source="hf:Snowflake/snowflake-arctic-base (dense-MoE hybrid)",
)

REDUCED = ModelConfig(
    name="arctic-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=7,
    padded_heads=8,
    n_kv_heads=1,
    d_ff=128,
    moe_d_ff=128,
    act="swiglu",
    n_experts=4,
    experts_per_token=2,
    dense_residual=True,
    source="reduced smoke variant",
)
