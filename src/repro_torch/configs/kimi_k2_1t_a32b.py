"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384e top-8 (paper-table).
[arXiv:2501.kimi2; unverified]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="kimi-k2-1t-a32b", family="moe", source="arXiv:2501.kimi2",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=112,
        moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048),
    ),
    reduced=lambda: dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=96)),
)
