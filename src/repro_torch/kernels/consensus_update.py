"""Launch wrappers of the consensus CUDA kernels: the fused round
(``csrc/consensus_round.cu``, ``launch``) and the flat update
(``csrc/consensus_update.cu``, ``launch_update``).

The round replaces the TPU kernels ``_round_kernel`` (ungated round) and
``_round_kernel_masked`` (edge-gated round of the dynamic topology, with
the optional zero-kick) of ``repro/kernels/consensus_update.py:141`` and
``:221``, with per-leaf scales (native and int8 wires) or per-block ones
(the fp8 wires); the whole-row ``_row_kernel`` and ``_row_kernel_masked``
there are the same functions under another TPU tiling. The gated round
moves the same bytes as the ungated one. The
kernel is bound by the bytes it moves: at the trainer's full-width
qwen3-4b shape (J = 2, deg = 1, bf16 theta and wire, 1,181,941,760 elements
per row) it reads and writes 22 B per element, about 52.0 GB a round, so
about 15.5 ms at the H100's 3.35 TB/s. A simple vectorised streaming pass
is the right first version for such a kernel: one pass over every operand
is the whole of the work. See the source for the design.

The flat update replaces the TPU kernel ``_kernel`` (``:74``, reached from
``consensus_update`` at ``:96``): the round's prox pull, dual update and
residual partials on flat vectors with a precomputed neighbor mean, bound
by its 5 reads and 2 writes per element.

The wrappers check device, dtype, shape, contiguity and alignment, and
raise on anything the kernels do not take. The round is written IN PLACE
over ``theta``, ``lam`` and ``bar_prev`` (which receives ``bar``), the flat
update over ``theta`` and ``lam``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_VEC = 8                       # elements per vector step in the kernels
_THETA_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_FP8_KINDS = {torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROUND_ARGS = [_I32, _I32, _I32, _I32, _I64, _I32, _I32, _I32] + [_P] * 16
_UPDATE_ARGS = [_I32, _I32, _I64, _I32] + [_P] * 9


def _require(cond: bool, msg: str, kernel: str = "consensus_round"):
    if not cond:
        raise ValueError(f"{kernel} kernel: {msg}")


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def launch(theta, lam, bar_prev, wires, scales, e_sym, alpha, eta_sum,
           eta_node, block_leaf, block_size: int, *, bar_w=None,
           inv_deg=None, kick_w=None, scales_per_block: bool = False):
    """Run one fused round on the card; returns the per-block partials
    (r_sq [J, nblocks], s_sq [J, nblocks]) as f32 tensors.

    theta [J, total] f32|bf16, lam/bar_prev [J, total] f32, wires
    [deg, J, total] in theta's dtype, int8, float8_e4m3fn or float8_e5m2,
    scales [deg, J, L] f32 ([deg, J, nblocks] with ``scales_per_block``),
    block_leaf [nblocks] int32, e_sym [deg, J] f32, alpha/eta_sum/eta_node
    [J] f32 — all CUDA tensors on one device, contiguous. ``bar_w``
    [deg, J] f32 and ``inv_deg`` [J] f32, given together, select the gated
    round; ``kick_w`` [deg, J] f32 (gated round only) adds the zero-kick.
    With per-leaf scales the ids in block_leaf must lie in [0, L): they
    index the scale rows on the card, and the caller checks the table once
    where it builds it (a check here would cost two reductions and a host
    sync every round).
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
    _require(wires.dtype in (theta.dtype, torch.int8, *_FP8_KINDS),
             f"wire dtype {wires.dtype} (takes theta's {theta.dtype}, int8 "
             "or an fp8 type)")
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
    _require(not scales_per_block or scales.shape[2] == nblocks,
             f"per-block scales shape {tuple(scales.shape)} != "
             f"({deg}, {j}, {nblocks})")
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
    wire_kind = (0 if wires.dtype == theta.dtype
                 else _FP8_KINDS.get(wires.dtype, 1))

    rsq = torch.empty((j, nblocks), dtype=torch.float32, device=dev)
    ssq = torch.empty((j, nblocks), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = build.entry_point("consensus_round", _ROUND_ARGS)(
            _THETA_KINDS[theta.dtype], wire_kind, j, deg, total, block_size,
            scales.shape[2], int(scales_per_block), wires.data_ptr(),
            scales.data_ptr(), block_leaf.data_ptr(), e_sym.data_ptr(),
            alpha.data_ptr(), eta_sum.data_ptr(), eta_node.data_ptr(),
            ptr(bar_w), ptr(inv_deg), ptr(kick_w), theta.data_ptr(),
            lam.data_ptr(), bar_prev.data_ptr(), rsq.data_ptr(),
            ssq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"consensus_round kernel launch failed: CUDA "
                           f"error {err}")
    return rsq, ssq


def launch_update(theta, lam, nbr_avg, bar, bar_prev, *, eta_sum, eta_node,
                  step_size, block_size: int = 65536):
    """Run the flat update on the card; returns the per-block partials
    (r_sq [nblocks], s_sq [nblocks]) as f32 tensors.

    theta, lam [N] f32|bf16, nbr_avg, bar, bar_prev [N] f32 — CUDA tensors
    on one device, contiguous and 16-byte aligned; eta_sum, eta_node,
    step_size numbers or tensors, taken as f32 (tensors stay on the card:
    no host sync). The blocks are ``min(block_size, N)`` elements, the
    reference's; ``block_size`` is a multiple of 8.
    """
    kern = "consensus_update"
    dev = theta.device
    _require(dev.type == "cuda", f"theta lies on {dev}, not on a CUDA card",
             kern)
    _require(theta.dim() == 1, f"theta must be [N], not "
             f"{tuple(theta.shape)}", kern)
    (n,) = theta.shape
    named = dict(theta=theta, lam=lam, nbr_avg=nbr_avg, bar=bar,
                 bar_prev=bar_prev)
    for name, t in named.items():
        _require(isinstance(t, torch.Tensor), f"{name} is not a tensor",
                 kern)
        _require(t.device == dev, f"{name} lies on {t.device}, theta on "
                 f"{dev}", kern)
        _require(t.shape == (n,), f"{name} shape {tuple(t.shape)} != "
                 f"({n},)", kern)
        _require(t.is_contiguous(), f"{name} is not contiguous", kern)
        _require(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned",
                 kern)
    for name in ("theta", "lam"):
        _require(named[name].dtype in _THETA_KINDS,
                 f"{name} dtype {named[name].dtype} (takes float32 or "
                 "bfloat16)", kern)
    for name in ("nbr_avg", "bar", "bar_prev"):
        _require(named[name].dtype == torch.float32,
                 f"{name} dtype {named[name].dtype} (takes float32)", kern)
    _require(n >= 1, "empty vectors", kern)
    _require(block_size > 0 and block_size % _VEC == 0,
             f"block_size {block_size} is not a positive multiple of {_VEC}",
             kern)
    # in place: the read-only inputs must not alias the updated buffers
    for name in ("nbr_avg", "bar", "bar_prev"):
        for out in ("theta", "lam"):
            _require(not _shares_storage(named[name], named[out]),
                     f"{name} shares storage with {out}", kern)
    _require(not _shares_storage(theta, lam),
             "theta shares storage with lam", kern)
    bs = min(block_size, n)
    nblocks = -(-n // bs)
    scalars = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                           device=dev).reshape(())
                           for x in (eta_sum, eta_node, step_size)])
    rsq = torch.empty((nblocks,), dtype=torch.float32, device=dev)
    ssq = torch.empty((nblocks,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.entry_point(kern, _UPDATE_ARGS)(
            _THETA_KINDS[theta.dtype], _THETA_KINDS[lam.dtype], n, bs,
            scalars.data_ptr(), nbr_avg.data_ptr(), bar.data_ptr(),
            bar_prev.data_ptr(), theta.data_ptr(), lam.data_ptr(),
            rsq.data_ptr(), ssq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"consensus_update kernel launch failed: CUDA "
                           f"error {err}")
    return rsq, ssq
