"""Serving launcher: batched prefill + greedy decode (port of
``repro/launch/serve.py``).

The prefill runs the full-sequence forward with ``use_kernel=True``: on the
card its attention (every arch but rwkv6) or time-mix scan (rwkv6) is the
hand-written CUDA kernel, on the CPU the kernel's plain version. The
prompt is then replayed through the decode cache one token at a time and
the continuation decoded greedily, as the reference does; the one-token
steps are plain PyTorch.

The audio and vision archs' frontends are stubs, as in the reference: the
prompt is a batch of random embeddings in place of tokens, and each
generated step feeds a random embedding drawn from the previous step's
first argmax token (a demo of the decode path, not a model of the
modality). The port draws the prompt's from a ``torch.Generator`` seeded
by ``--seed`` and hashes each step's on the device from ``--seed`` and
that token (``stub_step_embed``), where the reference draws both with
``jax.random``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --prompt-len 512 --gen-len 32          # full size, on the card

``--reduced`` is off unless given (the reference's flag is on by default
and cannot be turned off).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.model import stub_embeds

# the prefill's kernels: ops wrapper -> its launch counter
KERNELS = ("flash_attention", "rwkv6_scan")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap.parse_args(argv)


def _launches() -> dict:
    return {name: getattr(kops, name).launches for name in KERNELS}


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 tensors of uint32 values, in 16-bit halves
    of c so that no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def stub_step_embed(cfg: ArchConfig, seed: int, batch: int, device):
    """The frontend stubs' generated-step input: token ids [B] -> a
    standard normal embedding [B, D], a function of ``seed`` and the first
    sequence's token, as the reference folds that token into its key.
    It is hashed on the device (murmur3's finalizer over a counter, then
    Box-Muller), so that no step waits for the token on the host."""
    n = batch * cfg.d_model
    count = torch.arange(2 * n, dtype=torch.int64, device=device)
    salt = ((seed + 1) * 0x9E3779B1) & _M32

    def draw(tok: torch.Tensor) -> torch.Tensor:
        key = _fmix32((tok[0].to(torch.int64) + salt) & _M32)
        u = (_fmix32(_fmix32(count ^ key) ^ key).double() + 0.5) / 2.0 ** 32
        z = torch.sqrt(-2.0 * torch.log(u[:n])) * torch.cos(
            2.0 * math.pi * u[n:])
        return z.to(torch.float32).reshape(batch, cfg.d_model)
    return draw


def run(cfg: ArchConfig, args, params: dict | None = None,
        prompts: torch.Tensor | None = None,
        embeds: torch.Tensor | None = None, step_embed=None) -> dict:
    """Serve ``args.batch`` prompts of ``args.prompt_len`` tokens and decode
    ``args.gen_len`` more, greedily.

    ``params`` (the model's tree on ``args.device``) default to
    ``Model.init`` from ``args.seed``; ``prompts`` ([B, S] int64) to a
    seeded ``torch.Generator`` on the device. An arch with a frontend stub
    takes ``embeds`` ([B, S, D]) in place of prompts and, for each
    generated step, ``step_embed(tokens [B]) -> [B, D]``; both default to
    seeded random draws (``stub_embeds``, ``stub_step_embed``). Returns
    the record: the parameters, the prefill's batch (``batch``: tokens or
    embeds) and ``prompts`` (None for a frontend stub), the prefill logits
    [B, S, V], the replay's last logits [B, V], the generation's logits
    [gen_len - 1, B, V], the tokens [B, gen_len] (the first from the
    replay), the final decode state, prefill ms, decode ms per generated
    token, and the kernel launches of the prefill and of the decode
    (replay and generation).
    """
    device = resolve_device(args.device)
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if cfg.frontend != "none":
        if embeds is None:
            embeds = stub_embeds(cfg, (args.batch, args.prompt_len), gen,
                                 device)
        if step_embed is None:
            step_embed = stub_step_embed(cfg, args.seed, embeds.shape[0],
                                         device)
        batch = {"embeds": embeds}
        # the decode steps' inputs: the prompt's, then one per generated
        # token
        replay = [dict(token=None, embed_in=embeds[:, i])
                  for i in range(embeds.shape[1])]

        def step_input(tok):
            return dict(token=None, embed_in=step_embed(tok))
    else:
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab,
                                    (args.batch, args.prompt_len),
                                    generator=gen, device=device)
        batch = {"tokens": prompts}
        replay = [dict(token=prompts[:, i]) for i in range(prompts.shape[1])]

        def step_input(tok):
            return dict(token=tok)
    b, s = next(iter(batch.values())).shape[:2]
    max_len = s + args.gen_len
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    record = {"params": params, "batch": batch, "prompts": prompts}
    with torch.inference_mode():
        # prefill: the full-sequence forward, its kernels switched on
        before = _launches()
        sync()
        t0 = time.perf_counter()
        logits = model.prefill(params, batch, use_kernel=True)
        sync()
        record["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        record["prefill_launches"] = {
            k: v - before[k] for k, v in _launches().items()}
        record["prefill_logits"] = logits

        # replay the prompt through the decode cache, then generate
        before = _launches()
        state = model.init_decode_state(b, max_len, device)
        for inp in replay:
            lg, state = model.decode_step(params, state, max_len=max_len,
                                          **inp)
        record["replay_logits"] = lg
        next_tok = torch.argmax(lg, dim=-1)
        generated, step_logits = [next_tok], []
        sync()
        t0 = time.perf_counter()
        for _ in range(args.gen_len - 1):
            lg, state = model.decode_step(params, state, max_len=max_len,
                                          **step_input(next_tok))
            next_tok = torch.argmax(lg, dim=-1)
            generated.append(next_tok)
            step_logits.append(lg)
        sync()
        t_decode = time.perf_counter() - t0
    record["decode_ms_per_token"] = t_decode / max(args.gen_len - 1, 1) * 1e3
    record["decode_launches"] = {
        k: v - before[k] for k, v in _launches().items()}
    record["tokens"] = torch.stack(generated, dim=1)
    record["step_logits"] = (torch.stack(step_logits) if step_logits
                             else lg.new_zeros((0,) + tuple(lg.shape)))
    record["state"] = state
    if not bool(torch.isfinite(lg.float()).all()):
        raise RuntimeError("serve: the last logits are not finite")
    return record


def main(argv=None):
    args = parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    record = run(cfg, args)
    print(f"arch={cfg.arch_id} batch={args.batch} "
          f"prefill={record['prefill_ms']:.0f}ms "
          f"decode={record['decode_ms_per_token']:.1f}ms/tok "
          f"prefill launches {record['prefill_launches']}")
    print("sample generations (token ids):")
    for row in record["tokens"][:2].tolist():
        print("  ", row[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
