"""granite-moe-1b-a400m [moe] — 32 experts, top-8 (the reference's ``configs/granite_moe_1b_a400m.py``).

24L, d_model=1024, 16H (GQA kv=8, head_dim=64), expert d_ff=512,
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
Tied embeddings; every layer is MoE (no dense FFN).
"""

from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    pattern=(("attn", "moe"),),
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512),
    tied_embeddings=True,
)
