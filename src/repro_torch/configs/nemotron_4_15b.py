"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP (the reference's ``configs/nemotron_4_15b.py``).

32L, d_model=6144, 48H (GQA kv=8, head_dim=128), d_ff=24576,
vocab=256000 [arXiv:2402.16819; unverified].  Non-gated squared-ReLU MLP,
LayerNorm, untied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    activation="relu_sq",
    norm="layernorm",
)
