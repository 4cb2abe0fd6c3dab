"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="rwkv6-7b", family="ssm", source="arXiv:2404.05892",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536, head_dim=64,
        rwkv=True,
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16),
)
