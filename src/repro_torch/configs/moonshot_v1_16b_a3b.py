"""moonshot-v1-16b-a3b [moe] — Moonlight, 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="moonshot-v1-16b-a3b", family="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, head_dim=128,
        moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408),
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=96)),
)
