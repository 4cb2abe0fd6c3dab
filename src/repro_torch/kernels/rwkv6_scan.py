"""Launch wrapper of the chunked WKV6 scan CUDA kernel
(``csrc/rwkv6_scan.cu``).

The kernel replaces the TPU kernel ``_kernel`` of
``repro/kernels/rwkv6_scan.py:30`` (``rwkv6_scan`` at ``:81``): per
(batch, head) an f32 ``[hd, hd]`` state carried along the sequence in
chunks, each chunk's output from the inter-chunk term, the re-centred
strictly lower intra-chunk decay matrix and the diagonal bonus. Two blocks
per (batch, head) each own half of the state's value columns and walk the
chunks in order, the next chunk's loads (TMA) overlapping the current
chunk's products; bf16 inputs have their products on the tensor cores in
three TF32 parts (about f32's precision), f32 inputs on the CUDA cores in
f32 (see the source). It reads r, k, v and the log decays through their
strides, so the model layout ``[B, T, H, hd]`` needs no transposed copy;
rows that start 16-byte aligned are copied by TMA, others with plain
loads.

``launch`` checks device, dtype, shape and strides and raises on anything
the kernel does not take; it allocates y and the final state and launches
on the current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KINDS = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 64                  # the kernel is compiled for chunks up to 64
# (batch, head, time) axes of the model layout [B, T, H, hd]
AXES = (0, 2, 1)

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32] * 7 + [_P] * 8 + [ctypes.POINTER(ctypes.c_longlong), _P]


def _strides(x) -> list[int]:
    """x's element strides along AXES, a size-1 dim's replaced by one past
    x's extent (rounded up to 8 elements): the kernel never steps such a
    dim, and TMA takes the stride whatever the caller's was."""
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    span = -(-span // 8) * 8
    return [x.stride(ax) if x.shape[ax] > 1 else span for ax in AXES]


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"rwkv6_scan kernel: {msg}")


def info(dtype: torch.dtype, hd: int, chunk: int) -> dict:
    """The launch's shape on the current card for inputs of ``dtype`` at
    head dim ``hd`` and ``chunk``: {"blocks_per_head", "threads",
    "smem_bytes" (per block), "blocks_per_sm" (by shared memory,
    registers and threads), "registers" (per thread)}. Builds the kernel
    if needed."""
    _require(dtype in KINDS, f"dtype {dtype} (takes float32 or bfloat16)")
    _require(hd in HEAD_DIMS, f"head dim {hd} (takes {HEAD_DIMS})")
    _require(1 <= chunk <= MAX_CHUNK,
             f"chunk {chunk} (takes 1 to {MAX_CHUNK})")
    fn = getattr(build.load("rwkv6_scan"), "rwkv6_scan_info")
    fn.argtypes = [_I32, _I32, _I32, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(KINDS[dtype], hd, chunk, out)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_info failed: CUDA error {err}")
    return dict(zip(("blocks_per_head", "threads", "smem_bytes",
                     "blocks_per_sm", "registers"), out))


def plan(r, k, v, log_w, u, s0, *, chunk: int) -> dict:
    """Check the arguments of ``launch`` (any device) and return the
    launch's plan: {"b", "h", "t", "hd", "strides", "tma"} with the
    (batch, head, time) element strides of r, k, v and log_w and whether
    every row of them starts 16-byte aligned (TMA copies those; others take
    plain loads). Raises ValueError on anything the kernel does not take."""
    named = dict(r=r, k=k, v=v, log_w=log_w, u=u, s0=s0)
    for name, t in named.items():
        _require(isinstance(t, torch.Tensor), f"{name} is not a tensor")
        _require(t.device == r.device, f"{name} lies on {t.device}, r on "
                 f"{r.device}")
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
    _require(hd in HEAD_DIMS, f"head dim {hd} (takes {HEAD_DIMS})")
    _require(u.shape == (h, hd), f"u shape {tuple(u.shape)} != ({h}, {hd})")
    _require(s0.shape == (b, h, hd, hd),
             f"s0 shape {tuple(s0.shape)} != ({b}, {h}, {hd}, {hd})")
    _require(1 <= chunk <= MAX_CHUNK,
             f"chunk {chunk} (takes 1 to {MAX_CHUNK})")
    _require(t % chunk == 0,
             f"T {t} is not a multiple of the chunk {chunk}")
    ins = (r, k, v, log_w)
    strides = [_strides(x) for x in ins]
    # a TMA box row (hd of r, k and log_w; hd / 2 of v) is a multiple of 16
    # bytes, and every row starts 16-byte aligned
    tma = (hd // 2 * r.element_size() % 16 == 0
           and all(x.data_ptr() % 16 == 0
                   and all(st * x.element_size() % 16 == 0 for st in sts)
                   for x, sts in zip(ins, strides)))
    return dict(b=b, h=h, t=t, hd=hd, strides=strides, tma=tma)


def launch(r, k, v, log_w, u, s0, *, chunk: int):
    """Run the scan on the card; returns (y [B, T, H, hd] in r's dtype,
    S_final [B, H, hd, hd] f32), both new tensors.

    r, k, v: [B, T, H, hd], float32 or bfloat16 (one dtype); log_w: the
    same shape, float32; u: [H, hd] (any float dtype, widened to f32); s0:
    [B, H, hd, hd] float32. All on one CUDA device, head dims contiguous;
    hd 8, 16, 32, 64 or 128. T must be a multiple of ``chunk``, at most 64.
    """
    dev = r.device
    _require(dev.type == "cuda", f"r lies on {dev}, not on a CUDA card")
    p = plan(r, k, v, log_w, u, s0, chunk=chunk)
    b, h, t, hd = p["b"], p["h"], p["t"], p["hd"]
    u32 = u.to(torch.float32).contiguous()
    s0 = s0.contiguous()
    y = torch.empty(r.shape, dtype=r.dtype, device=dev)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *[x for sts in p["strides"] for x in sts],
        *[y.stride(ax) for ax in AXES])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.entry_point("rwkv6_scan", _ARGS)(
            KINDS[r.dtype], b, h, t, hd, chunk, int(p["tma"]), r.data_ptr(),
            k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u32.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    return y, s_out
