"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision] (port of
``repro/configs/llama32_vision_11b.py``).

40L d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256.  Every
5th layer is a gated cross-attention layer over vision tokens (8 cross
layers of 40).  The ViT vision encoder and projector are the allowed stub:
the model takes (B, vision_tokens=1601, d_model) projected patch
embeddings, which ``serve_batch`` draws.  The cross gate starts at 0
(``init="zeros"``), so a freshly initialised model ignores the image.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    vocab_size=128256,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    act="swiglu",
    cross_attn_every=5,
    vision_tokens=1601,  # one 448px tile: 1600 patches + cls
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision (+ arXiv:2407.21783)",
)

REDUCED = ModelConfig(
    name="llama-vision-reduced",
    family="vlm",
    n_layers=5,  # one pattern block: 4 self + 1 cross
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    act="swiglu",
    cross_attn_every=5,
    vision_tokens=17,
    rope_theta=500000.0,
    source="reduced smoke variant",
)
