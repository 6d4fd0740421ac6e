"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]
(port of ``repro/configs/mamba2_130m.py``).

24L d_model=768, attention-free, vocab=50280, ssm_state=128.  Mamba-2
130m: expand=2 -> d_inner=1536, head_dim=64 -> 24 SSD heads, conv width 4.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    source="arXiv:2405.21060 (Mamba-2 / SSD), state-spaces/mamba2-130m",
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    n_layers=2,
    d_model=128,
    vocab_size=512,
    ssm_state=32,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=16,
    source="reduced smoke variant",
)
