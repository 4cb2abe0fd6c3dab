"""Deterministic synthetic token pipeline (port of
``repro/data/synthetic.py``).

Batches are pure in (seed, step, node) and drawn with numpy exactly as the
reference draws them, so both packages see identical tokens and labels. The
"corpus" is Zipf-ish with induced bigram structure so that cross-entropy
actually falls during smoke training.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_node: int
    num_nodes: int = 1
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float32)


class SyntheticTokens:
    """Stateless batch source: batch(step) is pure in (seed, step, node).

    ``nodes`` (``(lo, hi)``, default every node) is the range of nodes to
    draw, a rank's block: node i's rows are the same whichever range holds
    it, since each node is seeded by its global id.
    """

    def __init__(self, cfg: DataConfig, *, device: torch.device | str,
                 dtype: torch.dtype = torch.int64,
                 nodes: tuple[int, int] | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.nodes = (0, cfg.num_nodes) if nodes is None else tuple(nodes)
        if not 0 <= self.nodes[0] < self.nodes[1] <= cfg.num_nodes:
            raise ValueError(f"node range {self.nodes} outside "
                             f"[0, {cfg.num_nodes})")
        self._probs = _zipf_probs(cfg.vocab, cfg.zipf_a)

    def batch_numpy(self, step: int, *, probe: bool = False) -> dict:
        """{tokens, labels: [J, B, S] int32} as the reference draws them
        (the rows of ``nodes``)."""
        cfg = self.cfg
        lo, hi = self.nodes
        domain = 1_000_003 if probe else 0
        out_tok = np.empty((hi - lo, cfg.batch_per_node, cfg.seq_len),
                           np.int32)
        for node in range(lo, hi):
            rng = np.random.default_rng(
                (cfg.seed * 7_919 + domain + node) * 2_654_435_761 + step)
            toks = rng.choice(cfg.vocab, p=self._probs,
                              size=(cfg.batch_per_node, cfg.seq_len))
            # induced bigram structure: every even position hints the next
            toks[:, 1::2] = (toks[:, 0::2] * 31 + 7) % cfg.vocab
            out_tok[node - lo] = toks
        labels = np.roll(out_tok, -1, axis=-1)
        labels[:, :, -1] = -1                      # masked final position
        return {"tokens": out_tok, "labels": labels}

    def batch(self, step: int, *, probe: bool = False) -> dict:
        """{tokens, labels: [J, B, S]} tensors on the source's device."""
        return {k: torch.from_numpy(v).to(device=self.device,
                                          dtype=self.dtype)
                for k, v in self.batch_numpy(step, probe=probe).items()}

    def embeds_batch_numpy(self, step: int, d_model: int, *,
                           probe: bool = False) -> dict:
        """Frontend-stub variant, as the reference draws it: {embeds:
        [J, B, S, d_model] float32 (precomputed frame or patch
        embeddings), labels: [J, B, S] int32}."""
        labels = self.batch_numpy(step, probe=probe)["labels"]
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 13 + step
                                    + (7 if probe else 0))
        # one draw for every node, then the range's rows
        emb = rng.normal(size=(cfg.num_nodes, cfg.batch_per_node,
                               cfg.seq_len, d_model)).astype(np.float32)
        lo, hi = self.nodes
        if (lo, hi) != (0, cfg.num_nodes):
            emb = np.ascontiguousarray(emb[lo:hi])
        return {"embeds": emb, "labels": labels}

    def embeds_batch(self, step: int, d_model: int, *,
                     probe: bool = False) -> dict:
        """``embeds_batch_numpy`` as tensors on the source's device (the
        labels in the source's integer dtype)."""
        b = self.embeds_batch_numpy(step, d_model, probe=probe)
        return {"embeds": torch.from_numpy(b["embeds"]).to(self.device),
                "labels": torch.from_numpy(b["labels"]).to(
                    device=self.device, dtype=self.dtype)}
