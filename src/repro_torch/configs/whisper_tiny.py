"""whisper-tiny [audio] — arXiv:2212.04356 (unverified).

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865; encoder-decoder
with a conv audio frontend (STUBBED: ``input_specs()`` provides the 1500
precomputed frame embeddings).  Decoder positions are learned; we extend
the table beyond the published 448 to satisfy the assigned shape cells
(noted in DESIGN.md §4).

PyTorch port: a copy of :mod:`repro.configs.whisper_tiny`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356; unverified",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    hidden_act="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_positions=1500,
    decoder_positions=448,
    pos_embedding="learned",
    frontend="audio",
    tie_embeddings=True,
    scan_layers=False,       # 4 layers: scan buys nothing
    n_microbatches=4,        # 6 heads don't shard 16-way; quarter the peak
    optimizer_moments="fp32",
)
