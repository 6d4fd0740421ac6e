"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave + MoE
[arXiv:2403.19887] (port of ``repro/configs/jamba_v01_52b.py``).

32L d_model=4096, 32 q-heads (GQA kv=8, head_dim 128), d_ff=14336,
vocab=65536, MoE 16 experts top-2 on every other layer.  Each block of 8
layers holds one attention layer (index 4) and 7 SSD mixers (the mixer
shared with mamba2, state 128, 128 heads of 64); MoE replaces the MLP on
odd layer indices (16 MoE layers of 32).  The full 32 layers (102 GB in
bf16) do not fit one 80 GB card; chip_smoke.py serves one pattern block.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    vocab_size=65536,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    act="swiglu",
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    block_len=8,
    attn_index_in_block=4,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=64,
    rope_theta=10000.0,
    source="arXiv:2403.19887 (Jamba), ai21labs/Jamba-v0.1",
)

REDUCED = ModelConfig(
    name="jamba-reduced",
    family="hybrid",
    n_layers=8,  # one pattern block
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    act="swiglu",
    n_experts=4,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    block_len=8,
    attn_index_in_block=4,
    ssm_state=32,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=16,
    source="reduced smoke variant",
)
