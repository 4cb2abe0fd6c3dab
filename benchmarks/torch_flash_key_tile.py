"""Time the port's "cc" flash kernel (``csrc/flash_attention.cu``) at key
tiles of 32 and 64 rows on one card, to choose its tile.

    PYTHONPATH=src python3 benchmarks/torch_flash_key_tile.py

Builds the source twice more with ``-DFLASH_KEY_TILE=32`` and ``=64`` (into
``build/kernels/``), and at each shape of ``SHAPES`` (B 4, S 512, causal,
the f32 shapes of ``chip_smoke.py`` phases 9 and 20 and the bf16 head dims
the kernel takes on its route) holds both against the plain version (2e-5
in f32, 2e-2 in bf16) and times them in turns (32, 64, 64, 32) by
``chip_smoke.time_device``, beside ``scaled_dot_product_attention``. Prints
one line per shape and the card's name and power limit; needs a card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (time_device; puts src on the path)

# (dtype, heads, head dim)
SHAPES = [("float32", 32, 128), ("float32", 32, 80), ("float32", 64, 112),
          ("bfloat16", 32, 16), ("bfloat16", 32, 32)]
TILES = (32, 64)


def build_variant(tile: int):
    """The kernel built with FLASH_KEY_TILE=tile; returns its launch
    function, typed as the wrapper's."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"flash_attention-key{tile}.so"
    subprocess.run([build.nvcc_path(), *build.flags("flash_attention"),
                    f"-DFLASH_KEY_TILE={tile}", "-o", str(out),
                    str(build.CSRC / "flash_attention.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.argtypes = fa._ARGS
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("torch_flash_key_tile: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    fns = {tile: build_variant(tile) for tile in TILES}
    for n, (dtype, h, hd) in enumerate(SHAPES):
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(60 + n)
        q, k, v = (torch.randn(4, h, 512, hd, generator=g,
                               device="cuda").to(dt) for _ in range(3))
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=True, window=0)
        tol = 2e-5 if dtype == "float32" else 2e-2

        def run():
            return fa.launch(q, k, v, causal=True, window=0, layout="bhsd",
                             kernel="cc")
        ms = {tile: [] for tile in TILES}
        for tile in TILES + TILES[::-1]:
            build._ENTRY_POINTS["flash_attention"] = fns[tile]
            err = float((run().float() - want).abs().max())
            chip_smoke.check(err <= tol, f"key tile {tile}, {dtype} hd "
                             f"{hd}: max abs error {err:.3g} (tol {tol})")
            ms[tile].append(chip_smoke.time_device(run, reps=50))
        lib = chip_smoke.time_device(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            reps=50)
        runs = {tile: ", ".join(f"{y:.4f}" for y in x)
                for tile, x in ms.items()}
        print(f"{dtype} hd {hd} heads {h}: " + ", ".join(
            f"key tile {tile} {min(x):.4f} ms ({runs[tile]})"
            for tile, x in ms.items()) + f"; library {lib:.4f} ms [{card}]",
            flush=True)
    build._ENTRY_POINTS.pop("flash_attention", None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
