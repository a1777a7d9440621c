"""qwen1.5-110b [dense] — QKV bias (the reference's ``configs/qwen1_5_110b.py``).

80L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=49152, vocab=152064
[hf:Qwen/Qwen1.5 family; hf].  SiLU-GLU, RMSNorm, RoPE θ=1e6, QKV bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
