"""Launch wrapper of the chunked WKV6 scan CUDA kernel
(``csrc/rwkv6_scan.cu``).

The kernel replaces the TPU kernel ``_kernel`` of
``repro/kernels/rwkv6_scan.py:30`` (``rwkv6_scan`` at ``:81``): per
(batch, head) an f32 ``[hd, hd]`` state carried along the sequence in
chunks, each chunk's output from the inter-chunk term, the re-centred
strictly lower intra-chunk decay matrix and the diagonal bonus. One block
per (head, batch) walks the chunks in order with the state in shared
memory; it is bound by its f32 operations (see the source). It reads r, k,
v and the log decays through their strides, so the model layout
``[B, T, H, hd]`` needs no transposed copy.

``launch`` checks device, dtype, shape and strides and raises on anything
the kernel does not take; it allocates y and the final state and launches
on the current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KINDS = {torch.float32: 0, torch.bfloat16: 1}
# (batch, head, time) axes of the model layout [B, T, H, hd]
AXES = (0, 2, 1)

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32] * 6 + [_P] * 8 + [ctypes.POINTER(ctypes.c_longlong), _P]


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"rwkv6_scan kernel: {msg}")


def launch(r, k, v, log_w, u, s0, *, chunk: int):
    """Run the scan on the card; returns (y [B, T, H, hd] in r's dtype,
    S_final [B, H, hd, hd] f32), both new tensors.

    r, k, v: [B, T, H, hd], float32 or bfloat16 (one dtype); log_w: the
    same shape, float32; u: [H, hd] (any float dtype, widened to f32); s0:
    [B, H, hd, hd] float32. All on one CUDA device, head dims contiguous.
    T must be a multiple of ``chunk``.
    """
    dev = r.device
    _require(dev.type == "cuda", f"r lies on {dev}, not on a CUDA card")
    named = dict(r=r, k=k, v=v, log_w=log_w, u=u, s0=s0)
    for name, t in named.items():
        _require(isinstance(t, torch.Tensor), f"{name} is not a tensor")
        _require(t.device == dev, f"{name} lies on {t.device}, r on {dev}")
    _require(r.dtype in KINDS, f"dtype {r.dtype} (takes float32 or "
             "bfloat16)")
    for name in ("k", "v"):
        _require(named[name].dtype == r.dtype,
                 f"{name} dtype {named[name].dtype} != r's {r.dtype}")
    for name in ("log_w", "s0"):
        _require(named[name].dtype == torch.float32,
                 f"{name} dtype {named[name].dtype} (takes float32)")
    _require(r.dim() == 4, "r must be a 4-d tensor")
    for name in ("k", "v", "log_w"):
        _require(named[name].shape == r.shape,
                 f"{name} shape {tuple(named[name].shape)} != r's "
                 f"{tuple(r.shape)}")
        _require(named[name].stride(3) == 1,
                 f"{name}'s head dim is not contiguous")
    _require(r.stride(3) == 1, "r's head dim is not contiguous")
    ax_b, ax_h, ax_t = AXES
    b, h, t, hd = r.shape[ax_b], r.shape[ax_h], r.shape[ax_t], r.shape[3]
    _require(u.shape == (h, hd), f"u shape {tuple(u.shape)} != ({h}, {hd})")
    _require(s0.shape == (b, h, hd, hd),
             f"s0 shape {tuple(s0.shape)} != ({b}, {h}, {hd}, {hd})")
    _require(chunk >= 1 and t % chunk == 0,
             f"T {t} is not a multiple of the chunk {chunk}")
    u32 = u.to(torch.float32).contiguous()
    s0 = s0.contiguous()
    y = torch.empty(r.shape, dtype=r.dtype, device=dev)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*[
        x.stride(ax) for x in (r, k, v, log_w, y) for ax in (ax_b, ax_h,
                                                              ax_t)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.entry_point("rwkv6_scan", _ARGS)(
            KINDS[r.dtype], b, h, t, hd, chunk, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), log_w.data_ptr(), u32.data_ptr(), s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    return y, s_out
