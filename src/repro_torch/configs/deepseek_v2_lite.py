"""deepseek-v2-lite [mla + moe] — multi-head latent attention beside DeepSeek-MoE's experts.

27L, d_model=2048, 16 heads of MLA (no q LoRA; a 512-wide K/V latent and one
64-wide RoPE key shared by the heads; q/k heads 128 + 64, v heads 128; YaRN
RoPE, factor 40 over 4096 positions), vocab=102400, untied head; layer 0 is
a dense MLP with d_ff=10944, layers 1-26 MoE with 64 routed experts of 1408
(top-6) and 2 shared [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite].
The port's own arch: the JAX package has no MLA, so it is registered in
``PORT_ARCHS`` beside the reference's ten.
"""

from repro_torch.models.config import MLACfg, MLAModelConfig, MoECfg

CONFIG = MLAModelConfig(
    name="deepseek-v2-lite",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,  # v_head_dim; the MLA mixer reads its widths from ``mla``
    d_ff=10944,  # layer-0 dense MLP width
    vocab=102400,
    prefix_pattern=(("mla", "dense0"),),
    pattern=(("mla", "moe"),),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
               factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0, mscale=0.707,
               mscale_all_dim=0.707),
)
