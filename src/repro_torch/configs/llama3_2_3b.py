"""llama3.2-3b [dense] — small llama3 (the reference's ``configs/llama3_2_3b.py``).

28L, d_model=3072, 24H (GQA kv=8, head_dim=128), d_ff=8192, vocab=128256.
SiLU-GLU, RMSNorm, RoPE θ=500k, tied embeddings, bf16.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    tied_embeddings=True,
)
