"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2 (the reference's ``configs/jamba_v0_1_52b.py``).

32L, d_model=4096, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=65536,
MoE 16 experts top-2 on every other layer; attention on 1 of each 8 layers
(position 4 of the period, per the paper's Jamba block) [arXiv:2403.19887;
hf].  Mamba: d_state=16, d_conv=4, expand=2.  No positional encoding
(use_rope=False) — Mamba layers carry position information.
"""

from repro_torch.models.config import ModelConfig, MoECfg, SSMCfg

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    pattern=(
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("attn", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
    ),
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, chunk=512),
    use_rope=False,
)
