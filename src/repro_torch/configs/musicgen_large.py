"""musicgen-large [audio] — decoder-only over EnCodec tokens; frontend STUB.
[arXiv:2306.05284; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="musicgen-large", family="audio", source="arXiv:2306.05284",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        frontend="audio_frames",
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, head_dim=16),
)
