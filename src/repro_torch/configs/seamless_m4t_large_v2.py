"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596] (port of ``repro/configs/seamless_m4t_large_v2.py``).

24L d_model=1024, 16 heads (kv=16), d_ff=8192, vocab=256206.  The
transformer backbone: a 24-layer full-attention encoder over stubbed
audio-frame embeddings (the mel + conformer-conv frontend is the one
allowed stub: (B, audio_frames, d_model), which ``serve_batch`` draws)
and a 24-layer causal decoder with cross attention in every layer.
Decode reads the encoder's keys and values, computed once by the prefill.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,       # decoder layers
    enc_layers=24,     # encoder layers
    d_model=1024,
    vocab_size=256206,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    act="gelu",
    audio_frames=3000,  # ~60 s at 50 Hz frontend output
    rope_theta=10000.0,
    source="arXiv:2308.11596 (SeamlessM4T), facebook/seamless-m4t-v2-large",
)

REDUCED = ModelConfig(
    name="seamless-reduced",
    family="audio",
    n_layers=2,
    enc_layers=2,
    d_model=128,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    act="gelu",
    audio_frames=64,
    source="reduced smoke variant",
)
