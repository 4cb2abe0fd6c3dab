"""llava-next-mistral-7b [vlm] — Mistral backbone, anyres vision STUB.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="llava-next-mistral-7b", family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        rope_theta=1_000_000.0, frontend="vision_patches",
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16),
)
