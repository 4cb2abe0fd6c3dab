"""Launch wrapper of the flash attention CUDA kernel
(``csrc/flash_attention.cu``).

The kernel replaces the TPU kernel ``_kernel`` of
``repro/kernels/flash_attention.py:26`` (``flash_attention`` at ``:82``):
causal, optionally sliding-window GQA attention with an online softmax kept
in f32, fully masked tiles skipped. It reads q, k and v through their
strides, so the model layout ``[B, S, H, hd]`` and the head-major
``[B, H, S, hd]`` take the same kernel without a transposed copy; query
head h reads KV head ``h // (H // K)``. At the serve path's shape it is
bound by the bytes it moves on this card, but computes in f32 on the CUDA
cores (the TPU kernel's arithmetic), which puts its floor at the f32 rate;
see the source.

``launch`` checks device, dtype, shape and strides and raises on anything
the kernel does not take; it allocates the output and launches on the
current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KINDS = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
# (batch, seq, head) axes of each layout
LAYOUTS = {"bshd": (0, 1, 2), "bhsd": (0, 2, 1)}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32] * 8 + [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong), _P]


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def launch(q, k, v, *, causal: bool, window: int, layout: str = "bshd"
           ) -> torch.Tensor:
    """Run the kernel on the card; returns the output in q's layout, dtype
    and shape (a new contiguous tensor).

    q: [B, S, H, hd] (``layout="bshd"``) or [B, H, S, hd] (``"bhsd"``);
    k, v: the same with K heads, H a multiple of K. float32 or bfloat16,
    one dtype and one CUDA device for all three; hd 16, 32, 64 or 128; the
    head dim contiguous (any strides elsewhere).
    """
    _require(layout in LAYOUTS, f"layout {layout!r} (takes {list(LAYOUTS)})")
    dev = q.device
    _require(dev.type == "cuda", f"q lies on {dev}, not on a CUDA card")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(isinstance(t, torch.Tensor) and t.dim() == 4,
                 f"{name} must be a 4-d tensor")
        _require(t.device == dev, f"{name} lies on {t.device}, q on {dev}")
        _require(t.dtype == q.dtype, f"{name} dtype {t.dtype} != q's "
                 f"{q.dtype}")
        _require(t.stride(3) == 1, f"{name}'s head dim is not contiguous")
    _require(q.dtype in KINDS, f"dtype {q.dtype} (takes float32 or "
             "bfloat16)")
    ax_b, ax_s, ax_h = LAYOUTS[layout]
    b, s, h, hd = q.shape[ax_b], q.shape[ax_s], q.shape[ax_h], q.shape[3]
    kv = k.shape[ax_h]
    _require(hd in HEAD_DIMS, f"head dim {hd} (takes {HEAD_DIMS})")
    _require(k.shape == v.shape, f"k {tuple(k.shape)} and v "
             f"{tuple(v.shape)} differ")
    want = [0] * 4
    for ax, n in ((ax_b, b), (ax_s, s), (ax_h, kv), (3, hd)):
        want[ax] = n
    _require(tuple(k.shape) == tuple(want),
             f"k shape {tuple(k.shape)} != {tuple(want)}")
    _require(kv >= 1 and h % kv == 0,
             f"{h} query heads are not a multiple of {kv} KV heads")
    _require(window >= 0, f"window {window} < 0")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(ax) for t in (q, k, v, out) for ax in (ax_b, ax_s, ax_h)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.entry_point("flash_attention", _ARGS)(
            KINDS[q.dtype], hd, b, h, kv, s, int(causal), int(window),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
