"""qwen3-4b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen3-4b", family="dense", source="hf:Qwen/Qwen3-8B",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16),
)
