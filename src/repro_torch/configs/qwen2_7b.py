"""qwen2-7b [dense] — GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen2-7b", family="dense", source="arXiv:2407.10671",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16),
)
