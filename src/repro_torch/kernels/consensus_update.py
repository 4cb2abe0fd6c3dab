"""Launch wrapper of the fused consensus-round CUDA kernel
(``csrc/consensus_round.cu``).

It replaces the TPU kernels ``_round_kernel`` (ungated round) and
``_round_kernel_masked`` (edge-gated round of the dynamic topology, with
the optional zero-kick) of ``repro/kernels/consensus_update.py:141`` and
``:221``; the whole-row ``_row_kernel`` and ``_row_kernel_masked`` there are
the same functions under another TPU tiling. The gated round moves the
same bytes as the ungated one. The
kernel is bound by the bytes it moves: at the trainer's full-width
qwen3-4b shape (J = 2, deg = 1, bf16 theta and wire, 1,181,941,760 elements
per row) it reads and writes 22 B per element, about 52.0 GB a round, so
about 15.5 ms at the H100's 3.35 TB/s. A simple vectorised streaming pass
is the right first version for such a kernel: one pass over every operand
is the whole of the work. See the source for the design.

The wrapper checks device, dtype, shape, contiguity and alignment, and
raises on anything the kernel does not take. The update is written IN
PLACE over ``theta``, ``lam`` and ``bar_prev`` (which receives ``bar``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VEC = 8                       # elements per vector step in the kernel
_THETA_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_launch_fn = None


def _fn():
    global _launch_fn
    if _launch_fn is None:
        fn = build.load("consensus_round").consensus_round_launch
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, i32, i32, i32, i64, i32, i32,
                       p, p, p, p, p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"consensus_round kernel: {msg}")


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def launch(theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum,
           eta_node, block_leaf, block_size: int, *, bar_w=None,
           inv_deg=None, kick_w=None):
    """Run one fused round on the card; returns the per-block partials
    (r_sq [J, nblocks], s_sq [J, nblocks]) as f32 tensors.

    theta [J, total] f32|bf16, lam/bar_prev [J, total] f32, wires
    [deg, J, total] in theta's dtype or int8, scales [deg, J, L] f32,
    block_leaf [nblocks] int32, e_sym [deg, J] f32, alpha/eta_sum/eta_node
    [J] f32 — all CUDA tensors on one device, contiguous. ``bar_w``
    [deg, J] f32 and ``inv_deg`` [J] f32, given together, select the gated
    round; ``kick_w`` [deg, J] f32 (gated round only) adds the zero-kick.
    The ids in
    block_leaf must lie in [0, L): they index the scale rows on the card,
    and the caller checks the table once where it builds it (a check here
    would cost two reductions and a host sync every round).
    """
    dev = theta.device
    _require(dev.type == "cuda", f"theta lies on {dev}, not on a CUDA card")
    j, total = theta.shape
    deg = wires.shape[0]
    _require((bar_w is None) == (inv_deg is None),
             "bar_w and inv_deg travel together")
    _require(kick_w is None or bar_w is not None,
             "kick_w needs the gated round (bar_w, inv_deg)")
    named = dict(theta=theta, lam=lam, bar_prev=bar_prev, wires=wires,
                 scales=scales, e_sym=e_sym, alpha=alpha, eta_sum=eta_sum,
                 eta_node=eta_node, block_leaf=block_leaf)
    gates = {k: v for k, v in (("bar_w", bar_w), ("inv_deg", inv_deg),
                               ("kick_w", kick_w)) if v is not None}
    named.update(gates)
    for name, t in named.items():
        _require(isinstance(t, torch.Tensor), f"{name} is not a tensor")
        _require(t.device == dev, f"{name} lies on {t.device}, theta on {dev}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(theta.dtype in _THETA_KINDS,
             f"theta dtype {theta.dtype} (takes float32 or bfloat16)")
    _require(wires.dtype in (theta.dtype, torch.int8),
             f"wire dtype {wires.dtype} (takes theta's {theta.dtype} or int8)")
    for name in ("lam", "bar_prev", "scales", "e_sym", "alpha", "eta_sum",
                 "eta_node", *gates):
        _require(named[name].dtype == torch.float32,
                 f"{name} dtype {named[name].dtype} (takes float32)")
    _require(block_leaf.dtype == torch.int32,
             f"block_leaf dtype {block_leaf.dtype} (takes int32)")
    _require(block_size % _VEC == 0 and block_size > 0,
             f"block_size {block_size} is not a positive multiple of {_VEC}")
    _require(total % block_size == 0,
             f"total {total} is not a multiple of block_size {block_size}")
    nblocks = total // block_size
    _require(lam.shape == (j, total) and bar_prev.shape == (j, total),
             "lam and bar_prev must have theta's shape")
    _require(wires.shape == (deg, j, total) and deg >= 1,
             f"wires shape {tuple(wires.shape)} != (deg, {j}, {total})")
    _require(scales.dim() == 3 and scales.shape[:2] == (deg, j),
             f"scales shape {tuple(scales.shape)} != (deg, J, L)")
    for name in ("e_sym", "bar_w", "kick_w"):
        if name in named:
            _require(named[name].shape == (deg, j),
                     f"{name} shape {tuple(named[name].shape)} != "
                     f"({deg}, {j})")
    for name in ("alpha", "eta_sum", "eta_node", "inv_deg"):
        if name in named:
            _require(named[name].shape == (j,), f"{name} must be [J]")
    _require(block_leaf.shape == (nblocks,),
             f"block_leaf shape {tuple(block_leaf.shape)} != ({nblocks},)")
    for name in ("theta", "lam", "bar_prev", "wires"):
        _require(named[name].data_ptr() % 16 == 0,
                 f"{name} is not 16-byte aligned")
    # in place: the wires must be copies, never views of the updated buffers
    for name in ("theta", "lam", "bar_prev"):
        _require(not _shares_storage(wires, named[name]),
                 f"wires share storage with {name}")
    nleaves = scales.shape[2]

    rsq = torch.empty((j, nblocks), dtype=torch.float32, device=dev)
    ssq = torch.empty((j, nblocks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _fn()(_THETA_KINDS[theta.dtype],
                    0 if wires.dtype == theta.dtype else 1,
                    j, deg, total, block_size, nleaves,
                    wires.data_ptr(), scales.data_ptr(), block_leaf.data_ptr(),
                    e_sym.data_ptr(), alpha.data_ptr(), eta_sum.data_ptr(),
                    eta_node.data_ptr(), ptr(bar_w), ptr(inv_deg),
                    ptr(kick_w), theta.data_ptr(), lam.data_ptr(),
                    bar_prev.data_ptr(), rsq.data_ptr(), ssq.data_ptr(),
                    stream)
    if err != 0:
        raise RuntimeError(f"consensus_round kernel launch failed: CUDA "
                           f"error {err}")
    return rsq, ssq
