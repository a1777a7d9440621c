"""internvl2-1b [vlm] — InternViT frontend (stub) + Qwen2-0.5B-style LLM
(the reference's ``configs/internvl2_1b.py``).

24L, d_model=896, 14H (GQA kv=2, head_dim=64), d_ff=4864, vocab=151655
[arXiv:2404.16821; hf].  The vision tower is a STUB: the caller
provides ``frontend_len`` precomputed patch embeddings (``launch.serve``
draws them from ``seed + 3``), projected and prepended to the token stream.  QKV bias + tied embeddings follow the
Qwen2 backbone.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tied_embeddings=True,
    frontend="vision",
    frontend_len=256,
)
