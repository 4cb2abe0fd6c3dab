"""hymba-1.5b [hybrid] — parallel attention + mamba heads, ssm_state=16.
[arXiv:2411.13676; hf]

Hymba runs attention and SSM heads in parallel within each block and uses
sliding-window attention in most layers. Meta-tokens and the few
global-attention layers are omitted, as in the reference.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64,
        ssm_state=16, sliding_window=1024,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, ssm_state=8, sliding_window=32),
)
