"""deepseek-moe-16b [moe] — fine-grained 64 routed + 2 shared experts (the reference's ``configs/deepseek_moe_16b.py``).

28L, d_model=2048, 16H (kv=16 ⇒ MHA, head_dim=128), expert d_ff=1408,
vocab=102400, 64 routed top-6 + 2 shared experts; layer 0 is a dense MLP
with d_ff=10944 [arXiv:2401.06066; hf].
"""

from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # layer-0 dense MLP width
    vocab=102400,
    prefix_pattern=(("attn", "dense0"),),
    pattern=(("attn", "moe"),),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)
