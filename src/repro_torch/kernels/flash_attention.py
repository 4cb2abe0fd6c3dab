"""Launch wrappers of the flash attention CUDA kernels
(``csrc/flash_attention_tc.cu`` and ``csrc/flash_attention.cu``).

Both replace the TPU kernel ``_kernel`` of
``repro/kernels/flash_attention.py:26`` (``flash_attention`` at ``:82``):
causal, optionally sliding-window GQA attention with an online softmax kept
in f32, fully masked tiles skipped. Both read q, k and v through their
strides, so the model layout ``[B, S, H, hd]`` and the head-major
``[B, H, S, hd]`` take the same kernel without a transposed copy; query
head h reads KV head ``h // (H // K)``.

Which kernel runs is a rule on the inputs' dtype and head dim, ``route``:
bf16 at head dim 64, 80, 112 or 128 goes to the wgmma kernel
(``flash_attention_tc.cu``: wgmma in bf16 with f32 sums, p rounded to bf16
for the p.v product, K/V streamed by TMA; hd 80 and 112 in tiles padded to
128 columns); float32 at every head dim, and bf16 at head dim 16 or 32, go
to the mma.sync kernel (``flash_attention.cu``, "cc" for its first design
on the CUDA cores: the products on the tensor cores in TF32, each f32
operand split into two TF32 parts so that the sums keep about f32's
precision, K/V double-buffered by cp.async; the TPU kernel's arithmetic
otherwise). The rule is not a fallback: a kernel that fails to build or
launch raises, and the other is never tried.

``launch`` checks device, dtype, shape and strides (``plan``) and raises on
anything the chosen kernel does not take; it allocates the output and
launches on the current stream. The wgmma kernel's TMA needs 16-byte
aligned bases and strides that are multiples of 8 elements: a tensor that
breaks that rule raises, it is neither copied nor sent to the other kernel.
The "cc" kernel takes any strides; ``plan`` picks its copy width
(``copy_bytes``): 16-byte copies when every row of q, k and v starts
16-byte aligned, else 4-byte ones, else (bf16 rows at an odd element)
plain loads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KINDS = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
TC_HEAD_DIMS = (64, 80, 112, 128)   # the tensor-core kernel's, in bf16
# (batch, seq, head) axes of each layout
LAYOUTS = {"bshd": (0, 1, 2), "bhsd": (0, 2, 1)}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32] * 9 + [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong), _P]
_TC_ARGS = [_I32] * 7 + [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong), _P]


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def route(dtype: torch.dtype, hd: int) -> str:
    """Which kernel takes inputs of ``dtype`` at head dim ``hd``: "tc" (the
    wgmma kernel) for bf16 at hd 64, 80, 112 or 128, else "cc" (the
    mma.sync kernel: float32, and bf16 at hd 16 or 32)."""
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cc"


def _tma_strides(t, axes) -> list[int]:
    """t's element strides along ``axes`` for a tensor map: a dim of size 1
    is never stepped, so its stride is replaced by one past the tensor's
    extent (keeping the map's strides increasing)."""
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    span = -(-span // 8) * 8
    return [t.stride(ax) if t.shape[ax] > 1 else span for ax in axes]


def _copy_bytes(tensors, axes) -> int:
    """The "cc" kernel's copy width for rows of ``tensors``: 16 (or 4) if
    every row starts 16- (or 4-) byte aligned, base and the strides of the
    dims longer than 1, else 2 (bf16 rows at an odd element: plain
    loads)."""
    for n in (16, 4):
        if all(t.data_ptr() % n == 0 and all(
                t.stride(ax) * t.element_size() % n == 0
                for ax in axes if t.shape[ax] > 1) for t in tensors):
            return n
    return 2


def plan(q, k, v, *, window: int, layout: str = "bshd",
         route_to: str | None = None) -> dict:
    """Check the arguments of ``launch`` (any device) and return the
    launch's plan: {"route", "b", "s", "h", "kv", "hd", "strides",
    "copy_bytes"} with the (batch, seq, head) element strides of q, k and v
    and the "cc" kernel's copy width (None on the "tc" route, which copies
    by TMA). Raises ValueError on anything the routed kernel (``route_to``,
    by default ``route``'s) does not take."""
    _require(layout in LAYOUTS, f"layout {layout!r} (takes {list(LAYOUTS)})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(isinstance(t, torch.Tensor) and t.dim() == 4,
                 f"{name} must be a 4-d tensor")
        _require(t.device == q.device, f"{name} lies on {t.device}, q on "
                 f"{q.device}")
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
    axes = (ax_b, ax_s, ax_h)
    kind = route_to or route(q.dtype, hd)
    if kind == "tc":
        strides = [_tma_strides(t, axes) for t in (q, k, v)]
        for name, t, st in zip("qkv", (q, k, v), strides):
            _require(t.data_ptr() % 16 == 0,
                     f"{name}'s base is not 16-byte aligned (the tensor-"
                     "core kernel's TMA needs it)")
            _require(all(x % 8 == 0 for x in st),
                     f"{name}'s strides {st} are not multiples of 8 "
                     "elements (the tensor-core kernel's TMA needs 16 "
                     "bytes)")
        copy = None
    else:
        strides = [[t.stride(ax) for ax in axes] for t in (q, k, v)]
        copy = _copy_bytes((q, k, v), axes)
    return dict(route=kind, b=b, s=s, h=h, kv=kv, hd=hd, strides=strides,
                copy_bytes=copy)


def launch(q, k, v, *, causal: bool, window: int, layout: str = "bshd",
           kernel: str | None = None) -> torch.Tensor:
    """Run the routed kernel on the card; returns the output in q's layout,
    dtype and shape (a new contiguous tensor).

    q: [B, S, H, hd] (``layout="bshd"``) or [B, H, S, hd] (``"bhsd"``);
    k, v: the same with K heads, H a multiple of K. float32 or bfloat16,
    one dtype and one CUDA device for all three; hd 16, 32, 64, 80, 112 or
    128; the
    head dim contiguous (any strides elsewhere, but see ``plan`` for the
    wgmma kernel's). ``kernel="cc"`` runs the mma.sync kernel on inputs
    that ``route`` sends to the wgmma one, to time the two on the same
    inputs; the model's wrappers (``kernels.ops``) never pass it.
    """
    dev = q.device
    _require(isinstance(q, torch.Tensor) and dev.type == "cuda",
             f"q lies on {getattr(q, 'device', None)}, not on a CUDA card")
    _require(kernel in (None, "cc"), f"kernel {kernel!r} (takes None or "
             "'cc')")
    p = plan(q, k, v, window=window, layout=layout, route_to=kernel)
    ax_b, ax_s, ax_h = LAYOUTS[layout]
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*[
        x for st in p["strides"] for x in st],
        *[out.stride(ax) for ax in (ax_b, ax_s, ax_h)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        if p["route"] == "tc":
            err = build.entry_point("flash_attention_tc", _TC_ARGS)(
                p["hd"], p["b"], p["h"], p["kv"], p["s"], int(causal),
                int(window), *ptrs, strides, stream)
        else:
            err = build.entry_point("flash_attention", _ARGS)(
                KINDS[q.dtype], p["hd"], p["b"], p["h"], p["kv"], p["s"],
                int(causal), int(window), p["copy_bytes"], *ptrs, strides,
                stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({p['route']}) kernel launch "
                           f"failed: CUDA error {err}")
    return out


def info(dtype: torch.dtype, hd: int) -> dict:
    """The "cc" kernel's launch shape on the current card for inputs of
    ``dtype`` at head dim ``hd``: {"key_tile", "threads", "smem_bytes" (per
    block, dynamic), "blocks_per_sm", "registers" (per thread)}. Builds the
    kernel if needed."""
    _require(dtype in KINDS, f"dtype {dtype} (takes float32 or bfloat16)")
    _require(hd in HEAD_DIMS, f"head dim {hd} (takes {HEAD_DIMS})")
    fn = getattr(build.load("flash_attention"), "flash_attention_info")
    fn.argtypes = [_I32, _I32, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(KINDS[dtype], hd, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_info failed: CUDA error {err}")
    return dict(zip(("key_tile", "threads", "smem_bytes", "blocks_per_sm",
                     "registers"), out))
