"""xlstm-125m [ssm] — alternating mLSTM and sLSTM blocks (the reference's ``configs/xlstm_125m.py``).

12L, d_model=768, 4H (head_dim=192), d_ff=0 (projections inside blocks),
vocab=50304 [arXiv:2405.04517; unverified].  mLSTM is the chunked
matrix-memory (linear-attention) form; sLSTM is the sequential scalar cell.
As in the reference, the sLSTM recurrent weights are full d×d rather than
block-diagonal per head.
"""

from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="xlstm-125m",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50304,
    pattern=(("mlstm", "none"), ("slstm", "none")),
    ssm=SSMCfg(chunk=512),
)
