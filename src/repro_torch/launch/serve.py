"""Serving launcher: batched prefill + greedy decode (port of
``repro/launch/serve.py``).

The prefill runs the full-sequence forward with ``use_kernel=True``: on the
card its attention (dense archs) or time-mix scan (rwkv6) is the
hand-written CUDA kernel, on the CPU the kernel's plain version. The
prompt is then replayed through the decode cache one token at a time and
the continuation decoded greedily, as the reference does; the one-token
steps are plain PyTorch.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --prompt-len 512 --gen-len 32          # full size, on the card

``--reduced`` is off unless given (the reference's flag is on by default
and cannot be turned off). Archs with a modality frontend are not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model

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


def run(cfg: ArchConfig, args, params: dict | None = None,
        prompts: torch.Tensor | None = None) -> dict:
    """Serve ``args.batch`` prompts of ``args.prompt_len`` tokens and decode
    ``args.gen_len`` more, greedily.

    ``params`` (the model's tree on ``args.device``) default to
    ``Model.init`` from ``args.seed``; ``prompts`` ([B, S] int64) to a
    seeded ``torch.Generator`` on the device. Returns the record: the
    parameters and prompts, the prefill logits [B, S, V], the replay's
    last logits [B, V], the generation's logits [gen_len - 1, B, V], the
    tokens [B, gen_len] (the first from the replay), the final decode
    state, prefill ms, decode ms per generated token, and the kernel
    launches of the prefill and of the decode (replay and generation).
    """
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.arch_id}: archs with a {cfg.frontend} frontend are not "
            "ported")
    device = resolve_device(args.device)
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen, device)
    if prompts is None:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                                generator=gen, device=device)
    b, s = prompts.shape
    max_len = s + args.gen_len
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    record = {"params": params, "prompts": prompts}
    with torch.inference_mode():
        # prefill: the full-sequence forward, its kernels switched on
        before = _launches()
        sync()
        t0 = time.perf_counter()
        logits = model.prefill(params, {"tokens": prompts}, use_kernel=True)
        sync()
        record["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        record["prefill_launches"] = {
            k: v - before[k] for k, v in _launches().items()}
        record["prefill_logits"] = logits

        # replay the prompt through the decode cache, then generate
        before = _launches()
        state = model.init_decode_state(b, max_len, device)
        for i in range(s):
            lg, state = model.decode_step(params, state, prompts[:, i],
                                          max_len=max_len)
        record["replay_logits"] = lg
        next_tok = torch.argmax(lg, dim=-1)
        generated, step_logits = [next_tok], []
        sync()
        t0 = time.perf_counter()
        for _ in range(args.gen_len - 1):
            lg, state = model.decode_step(params, state, next_tok,
                                          max_len=max_len)
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
