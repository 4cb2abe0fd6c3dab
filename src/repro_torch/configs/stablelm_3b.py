"""stablelm-3b [dense] — MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b; unverified]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="stablelm-3b", family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304, head_dim=80,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16),
)
