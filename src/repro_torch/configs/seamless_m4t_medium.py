"""seamless-m4t-medium [audio] — enc-dec multimodal backbone (the reference's
``configs/seamless_m4t_medium.py``).

12L enc + 12L dec, d_model=1024, 16H (kv=16 ⇒ MHA), d_ff=4096,
vocab=256206 [arXiv:2308.11596; hf].  The speech frontend (w2v-BERT
feature extractor) is a STUB: the caller provides precomputed frame
embeddings of length ``frontend_len`` (``launch.serve`` draws them from
``seed + 2``).  Norm/activation choices beyond the
assignment row (LayerNorm + GELU) follow the NLLB-family defaults.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    is_encoder_decoder=True,
    n_enc_layers=12,
    frontend="audio",
    frontend_len=1024,
    norm="layernorm",
    activation="gelu",
    rope_theta=10_000.0,
    tied_embeddings=True,
)
