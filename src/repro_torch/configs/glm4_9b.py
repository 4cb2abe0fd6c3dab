"""glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="glm4-9b", family="dense", source="hf:THUDM/glm-4-9b",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, head_dim=128,
        qkv_bias=True, rope_theta=10_000.0,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16),
)
