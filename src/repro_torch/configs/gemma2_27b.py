"""gemma2-27b [dense] — local+global alternating attention, logit softcaps (the reference's ``configs/gemma2_27b.py``).

46L, d_model=4608, 32H (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000 [arXiv:2408.00118; hf].  Sliding window 4096 on local layers,
attn softcap 50, final softcap 30, pre+post RMSNorm, GeGLU, tied
embeddings with sqrt(d) embedding scale.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    pattern=(("attn_local", "mlp"), ("attn", "mlp")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    activation="gelu_glu",
    embed_scale=True,
    tied_embeddings=True,
)
