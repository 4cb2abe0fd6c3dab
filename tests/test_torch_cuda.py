"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card. The module
imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-5 / atol 1e-5 in float32 (the block partial sums are
taken in another order). The edge-gated kernel's theta', lam' and bar equal
the plain version's bit for bit (both round after every multiply and add,
over the offsets in the same order); its r^2 and s^2 hold to rtol 1e-5. So
do the per-block (fp8) rounds and the flat update's theta' and lam'. The
int8 and fp8 codecs' bytes on the card equal the CPU's. The flash attention
and RWKV6 scan kernels hold to the reference's bounds against their plain
versions (stated at each test), and reduced float32 serving on the card to
the CPU's tokens and logits.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch import wire
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.optim.flatten import FlatLayout, LeafSpec
from torch_round_cases import (NAMES, fp8_round_case, masked_round_case,
                               masked_torch_args, round_case, torch_args)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_cuda_kernel_matches_plain_version(wire):
    """The CUDA kernel against the plain version on the card (skips
    without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(3)
    case = round_case(rng, j=4, deg=2, nleaves=5, bs=64)
    args = torch_args(case)
    if wire == "native":
        args[3] = torch.from_numpy(
            rng.normal(size=case["wires"].shape).astype(np.float32))
        args[4] = torch.ones_like(args[4])
    dev = torch.device("cuda")
    args = [a.to(dev) for a in args]
    bl = torch.from_numpy(case["block_leaf"]).to(dev)
    want = ref.consensus_round_ref(*args, block_leaf=bl, block_size=64)
    before = ops.consensus_round.launches
    got = ops.consensus_round(*[a.clone() for a in args[:3]], *args[3:],
                              block_leaf=bl, block_size=64)
    torch.cuda.synchronize()
    assert ops.consensus_round.launches == before + 1
    for a, b, name in zip(got, want, NAMES):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kick", [False, True])
@pytest.mark.parametrize("theta_dtype,wire", [
    ("float32", "int8"), ("float32", "native"), ("bfloat16", "native"),
    ("bfloat16", "int8")])
def test_cuda_masked_kernel_matches_plain_version(theta_dtype, wire, kick):
    """The edge-gated kernel (ghost row, dead offset, kicks on gated
    edges) against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    case = masked_round_case(np.random.default_rng(17), j=4, deg=3,
                             nleaves=5, bs=64, wire=wire,
                             theta_dtype=theta_dtype, kick=kick)
    dev = torch.device("cuda")
    args, kw = masked_torch_args(case, dev)
    bl = torch.from_numpy(case["block_leaf"]).to(dev)
    want = ref.consensus_round_ref(*args, block_leaf=bl, block_size=64, **kw)
    before = (ops.consensus_round.launches,
              ops.consensus_round.masked_launches)
    got = ops.consensus_round(*[a.clone() for a in args[:3]], *args[3:],
                              block_leaf=bl, block_size=64, **kw)
    torch.cuda.synchronize()
    assert (ops.consensus_round.launches,
            ops.consensus_round.masked_launches) == (before[0],
                                                     before[1] + 1)
    for a, b, name in zip(got[:3], want[:3], NAMES):
        assert torch.equal(a, b), name
    for a, b, name in zip(got[3:], want[3:], NAMES[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", ["inv_deg", "bar_w"])
def test_cuda_masked_kernel_refuses_partial_gates(drop):
    """kick_w without bar_w, and bar_w without inv_deg, are refused before
    anything is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    case = masked_round_case(np.random.default_rng(2), j=3, deg=2,
                             nleaves=2, bs=64)
    args, kw = masked_torch_args(case, torch.device("cuda"))
    bl = torch.from_numpy(case["block_leaf"]).cuda()
    kw.pop(drop)
    if drop == "bar_w":
        kw.pop("inv_deg")
    before = ops.consensus_round.masked_launches
    with pytest.raises(ValueError, match="travel together|needs the gated"):
        ops.consensus_round(*args, block_leaf=bl, block_size=64, **kw)
    assert ops.consensus_round.masked_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ungated", "gated", "kick"])
@pytest.mark.parametrize("theta_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_cuda_per_block_round_matches_plain_version(fmt, theta_dtype,
                                                    variant):
    """The round with fp8 wires and per-block scales (ungated, gated, gated
    with kicks) against the plain version on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    if variant == "ungated":
        case = fp8_round_case(rng, j=4, deg=3, nleaves=5, bs=64, fmt=fmt)
        args, kw = [a.to(dev) for a in torch_args(case)], {}
        if theta_dtype == "bfloat16":
            args[0] = args[0].to(torch.bfloat16)
    else:
        case = masked_round_case(rng, j=4, deg=3, nleaves=5, bs=64, wire=fmt,
                                 theta_dtype=theta_dtype,
                                 kick=variant == "kick")
        args, kw = masked_torch_args(case, dev)
    bl = torch.from_numpy(case["block_leaf"]).to(dev)
    want = ref.consensus_round_ref(*args, block_leaf=bl, block_size=64,
                                   scales_per_block=True, **kw)
    counts = ("launches", "masked_launches", "per_block_launches")
    before = [getattr(ops.consensus_round, c) for c in counts]
    got = ops.consensus_round(*[a.clone() for a in args[:3]], *args[3:],
                              block_leaf=bl, block_size=64,
                              scales_per_block=True, **kw)
    torch.cuda.synchronize()
    after = [getattr(ops.consensus_round, c) - b
             for c, b in zip(counts, before)]
    assert after == ([1, 0, 1] if variant == "ungated" else [0, 1, 1])
    for a, b, name in zip(got[:3], want[:3], NAMES):
        assert torch.equal(a, b), name
    for a, b, name in zip(got[3:], want[3:], NAMES[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_cuda_encode_equals_cpu(fmt, dtype):
    """The quantizing codecs' bytes on the card equal their bytes on the
    CPU (scales included: no division by a reciprocal on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    bs = 128
    lay = FlatLayout((LeafSpec(("a",), 0, 1000, 1024, (1000,), torch.float32),
                      LeafSpec(("b",), 1024, 300, 512, (300,),
                               torch.float32)), bs)
    rng = np.random.default_rng(5)
    buf = rng.normal(size=(3, lay.total)).astype(np.float32)
    buf *= np.repeat(np.exp(rng.uniform(-6, 6, size=(3, lay.num_blocks))),
                     bs, axis=1).astype(np.float32)
    buf[:, 1000:1024] = 0.0
    buf[:, 1324:] = 0.0
    x = torch.from_numpy(buf).to(getattr(torch, dtype))
    codec = wire.get_codec(fmt, lay)
    if fmt != "int8":
        codec.chunk_blocks = 3
    card = codec.encode(x.cuda())
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), codec.encode(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8 * 1024, 5000, 777])
def test_cuda_flat_update_matches_plain_version(n, dtype):
    """The flat update kernel against the plain version on the card: theta'
    and lam' bit for bit, r^2 and s^2 to rtol 1e-5; N a block multiple, N
    not one, N below one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(n)
    dev = torch.device("cuda")
    args = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
            for _ in range(5)]
    args[0] = args[0].to(getattr(torch, dtype))
    args[1] = args[1].to(getattr(torch, dtype))
    kw = dict(eta_sum=0.7, eta_node=0.35, step_size=0.2, block_size=1024)
    want = ref.consensus_update_ref(*args, **kw)
    before = ops.consensus_update.launches
    got = ops.consensus_update(args[0].clone(), args[1].clone(), *args[2:],
                               **kw)
    torch.cuda.synchronize()
    assert ops.consensus_update.launches == before + 1
    for a, b, name in zip(got[:2], want[:2], ("theta", "lam")):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b, name in zip(got[2:], want[2:], ("r_sq", "s_sq")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)


# flash attention: (b, h, kv heads, s, hd, causal, window) — the reference
# tests' shapes and the model's, a ragged S below one tile, S not a
# multiple of the kernel's 64-row tile, and head dims 80 and 112
FLASH_CASES = [
    (1, 2, 2, 128, 32, True, 0), (2, 4, 2, 256, 64, True, 0),
    (1, 4, 1, 256, 32, True, 64), (1, 2, 2, 128, 32, False, 0),
    (1, 8, 2, 128, 128, True, 0), (2, 4, 2, 16, 16, True, 0),
    (1, 4, 4, 96, 16, True, 40), (1, 4, 2, 256, 128, True, 100),
    # the zoo's head dims: stablelm-3b's 80 (MHA), kimi-k2's 112 (GQA 8/1,
    # a window, S not a multiple of the tile); in bf16 these run the
    # "cc" kernel through kernel="cc" (the route takes them to the
    # tensor-core one, TC_CASES below)
    (2, 4, 4, 256, 80, True, 0), (1, 8, 1, 112, 112, True, 64),
    (1, 4, 4, 128, 80, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain_version(case, dtype, layout):
    """The flash kernel against its plain version on the card (K/V of
    fewer heads read by the kernel's head index, repeated for the plain
    version): atol 2e-5 in float32, 2e-2 in bf16 (the plain version
    rounds logits and probabilities to bf16, the kernel keeps f32). bf16
    at hd 80 and 112 runs the "cc" kernel through
    ``fa.launch(kernel="cc")``, which ``ops`` never passes, so the launch
    counters stay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, kh, s, hd, causal, window = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(s + hd)
    q, k, v = (torch.randn(b, n, s, hd, generator=g, device="cuda").to(dt)
               for n in (h, kh, kh))
    kr = k.repeat_interleave(h // kh, dim=1)
    vr = v.repeat_interleave(h // kh, dim=1)
    want = ref.flash_attention_ref(q, kr, vr, causal=causal, window=window)
    before = ops.flash_attention.launches
    cc_only = dt == torch.bfloat16 and hd in (80, 112)
    args = (q, k, v) if layout == "bhsd" else \
        tuple(t.transpose(1, 2) for t in (q, k, v))
    if cc_only:
        assert fa.route(dt, hd) == "tc"
        got = fa.launch(*args, causal=causal, window=window, layout=layout,
                        kernel="cc")
    elif layout == "bhsd":
        got = ops.flash_attention_hmajor(*args, causal=causal,
                                         window=window)
    else:
        got = ops.flash_attention(*args, causal=causal, window=window)
    if layout == "bshd":
        got = got.transpose(1, 2)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + (not cc_only)
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


# the "cc" kernel (mma.sync in TF32 parts) at the shapes chip_smoke.py
# times it: f32 at B 4, S 512, 32 heads of 128 (key tiles through both
# cp.async buffers, causal), and bf16 at hd 16 and 32, its own route
CC_PATH_CASES = [("float32", 128), ("bfloat16", 16), ("bfloat16", 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", CC_PATH_CASES)
def test_cuda_flash_cc_kernel_at_path_shape(dtype, hd):
    """Through ``ops`` on the "cc" route (one launch, none on the
    tensor-core kernel), against the plain version evaluated in f32 on the
    same inputs: atol 2e-5 in f32, 2e-2 in bf16 (the output's rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(70 + hd)
    q, k, v = (torch.randn(4, 32, 512, hd, generator=g, device="cuda").to(dt)
               for _ in range(3))
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=0)
    assert fa.route(dt, hd) == "cc"
    before = (ops.flash_attention.launches, ops.flash_attention.tc_launches)
    got = ops.flash_attention_hmajor(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - before[0],
            ops.flash_attention.tc_launches - before[1]) == (1, 0)
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset,copy", [
    ("float32", 1, 4), ("bfloat16", 2, 4), ("bfloat16", 1, 2)])
def test_cuda_flash_cc_kernel_misaligned_views(dtype, offset, copy):
    """q, k and v as views ``offset`` elements into their buffers: rows
    that do not start 16-byte aligned take the 4-byte copies (bf16 rows at
    an odd element, plain loads), as ``plan`` reports, and the kernel still
    holds its plain version (S 200: a ragged last key tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dt = getattr(torch, dtype)
    shape, n = (2, 4, 200, 32), 2 * 4 * 200 * 32
    g = torch.Generator(device="cuda").manual_seed(80 + offset)
    q, k, v = (torch.randn(n + 8, generator=g, device="cuda").to(dt)
               [offset:offset + n].view(shape) for _ in range(3))
    assert fa.plan(q, k, v, window=0, layout="bhsd")["copy_bytes"] == copy
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=0)
    got = fa.launch(q, k, v, causal=True, window=0, layout="bhsd")
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


# the tensor-core flash kernel's edges (bf16, head dim 64, 80, 112 or 128),
# through ops: (b, h, kv heads, s, hd, window) — the serve path's shape at
# B 1, a window smaller than the kernel's 128-key tile, GQA 32/8 at hd 128,
# hd 64, and S 96, below one 128-row tile; then the padded tile's widths:
# stablelm-3b's 32/32 heads of 80 at S 512, hd 80 at S 96, kimi-k2's GQA
# 64/8 at hd 112 with a window of 40, and hd 112 at S 96
TC_CASES = [(1, 32, 32, 512, 128, 0), (1, 4, 4, 256, 128, 40),
            (1, 32, 8, 256, 128, 0), (2, 4, 2, 256, 64, 0),
            (2, 4, 2, 96, 64, 0),
            (1, 32, 32, 512, 80, 0), (2, 4, 4, 96, 80, 0),
            (1, 64, 8, 256, 112, 40), (2, 4, 2, 96, 112, 0)]
# a kernel that never ends (an mbarrier expecting more bytes than TMA
# delivers waits for ever) fails its test after this many seconds
TC_TIMEOUT_S = 60.0


def _sync_within(seconds: float = TC_TIMEOUT_S) -> None:
    """Wait for the card's queue to drain, and fail the test if it has not
    within ``seconds``: a hang of the tensor-core kernel becomes a failure
    (the kernel itself traps after 2^26 polls of one barrier)."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.monotonic()
    while not ev.query():
        if time.monotonic() - t0 > seconds:
            pytest.fail(f"the flash kernel did not finish in {seconds} s")
        time.sleep(1e-3)
    torch.cuda.synchronize()


def _tc_inputs(b, h, kh, s, hd, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, n, s, hd, generator=g,
                             device="cuda").bfloat16() for n in (h, kh, kh))


def _tc_want(q, k, v, window):
    """The plain version evaluated in f32 on the same inputs, cast to bf16
    (the TPU kernel's arithmetic: q, k, v widened to f32 inside)."""
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (x.repeat_interleave(n_rep, dim=1).float() for x in (k, v))
    return ref.flash_attention_ref(q.float(), kr, vr, causal=True,
                                   window=window).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", TC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_tensor_core_kernel(case, layout):
    """bf16 at hd 64, 80, 112 and 128 runs the tensor-core kernel (both
    counters move), held at 2e-2 against the plain version evaluated in f32
    (the kernel rounds p to bf16 for its p.v product); a launch that does
    not end within TC_TIMEOUT_S fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, kh, s, hd, window = case
    q, k, v = _tc_inputs(b, h, kh, s, hd, seed=s + hd + window)
    want = _tc_want(q, k, v, window)
    before = (ops.flash_attention.launches, ops.flash_attention.tc_launches)
    if layout == "bhsd":
        got = ops.flash_attention_hmajor(q, k, v, causal=True, window=window)
    else:
        got = ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                  causal=True, window=window).transpose(1, 2)
    _sync_within()
    assert (ops.flash_attention.launches - before[0],
            ops.flash_attention.tc_launches - before[1]) == (1, 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("s,hd", [(192, 128), (200, 80), (200, 112)])
def test_cuda_flash_tensor_core_ragged_sequence(layout, s, hd):
    """S 192 or 200 is not a multiple of the kernel's 128-row tile: TMA
    fills the rows past the end with zeros (and, at hd 80 and 112, the
    columns past hd), the kernel masks those keys and writes no row past
    the end. The wrappers in ``ops`` refuse such an S (the reference's
    S % min(128, S) rule), so the kernel is launched here directly; its
    route is the tensor-core one. A launch that does not end within
    TC_TIMEOUT_S fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    q, k, v = _tc_inputs(2, 4, 2, s, hd, seed=s if hd == 128 else s + hd)
    want = _tc_want(q, k, v, 0)
    assert fa.route(q.dtype, hd) == "tc"
    with pytest.raises(ValueError, match="multiple of the block"):
        ops.flash_attention_hmajor(q, k, v)
    if layout == "bhsd":
        got = fa.launch(q, k, v, causal=True, window=0, layout="bhsd")
    else:
        got = fa.launch(*(t.transpose(1, 2) for t in (q, k, v)), causal=True,
                        window=0, layout="bshd").transpose(1, 2)
    _sync_within()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_cuda_flash_tensor_core_refuses_misaligned_view(layout):
    """A bf16 tensor whose base is not 16-byte aligned cannot be read by
    TMA: the wrapper raises before any launch (no copy, no other kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    shape = (1, 4, 128, 128) if layout == "bhsd" else (1, 128, 4, 128)
    n = 4 * 128 * 128
    q = torch.randn(n + 8, device="cuda").bfloat16()[1:1 + n].view(shape)
    k = torch.randn(shape, device="cuda").bfloat16()
    before = (ops.flash_attention.launches, ops.flash_attention.tc_launches)
    fn = ops.flash_attention_hmajor if layout == "bhsd" \
        else ops.flash_attention
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(q, k, k)
    assert (ops.flash_attention.launches,
            ops.flash_attention.tc_launches) == before


SCAN_CASES = [(1, 2, 64, 16, 16), (2, 3, 128, 32, 32), (1, 1, 96, 8, 32),
              (1, 4, 256, 64, 64), (2, 4, 64, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv6_scan_matches_plain_version(case, dtype):
    """The scan kernel (model layout, through ops) against its plain
    version on the card: y to 3e-5 * max|y| in float32 and 8e-3 * max|y|
    in bf16 (the reference's bounds), the f32 state to the same share of
    max|state|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, t, hd, chunk = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(t + hd)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    r, k, v = rnd(b, t, h, hd).to(dt), rnd(b, t, h, hd, scale=0.5).to(dt), \
        rnd(b, t, h, hd).to(dt)
    w = torch.exp(-torch.exp(rnd(b, t, h, hd, scale=0.5)))
    u = rnd(h, hd, scale=0.1).to(dt)
    s0 = rnd(b, h, hd, hd, scale=0.1)
    log_w = torch.log(torch.clamp_min(w, 1e-38))
    y_want, s_want = ref.rwkv6_scan_ref(
        *(x.transpose(1, 2) for x in (r, k, v, log_w)), u, s0)
    before = ops.rwkv6_scan.launches
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    assert y.dtype == dt and y.shape == r.shape
    rtol = 3e-5 if dtype == "float32" else 8e-3
    scale = float(y_want.float().abs().max()) + 1e-6
    torch.testing.assert_close(y.float(), y_want.transpose(1, 2).float(),
                               rtol=0, atol=rtol * scale)
    torch.testing.assert_close(s, s_want, rtol=0,
                               atol=rtol * float(s_want.abs().max()))


# the scan at the serve path's width: (b, h, t, hd, chunk, log decay, pad)
# — one rwkv6-7b layer's heads at T 512, chunk 32; strong decay (log w
# about -20 a step) at chunk 8, where the re-centred factors reach e^{+-80};
# rows that start off 16-byte alignment (plain loads instead of TMA)
SCAN_PATH_CASES = [(1, 8, 512, 64, 32, None, 0), (2, 4, 512, 64, 8, -20.0, 0),
                   (2, 3, 128, 64, 32, None, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_PATH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv6_scan_path_shapes(case, dtype):
    """The scan kernel (through ops) at the path's head dim and chunk, at a
    strong decay, and on rows off 16-byte alignment, against its plain
    version: y to 3e-5 * max|y| in float32 and 8e-3 * max|y| in bf16, the
    f32 state to the same share of max|state|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, t, hd, chunk, decay, pad = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(t + hd + chunk)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    r, k, v = (rnd(b, t, h, hd + pad, scale=sc).to(dt)[..., pad:]
               for sc in (1.0, 0.5, 1.0))
    if decay is None:
        w = torch.exp(-torch.exp(rnd(b, t, h, hd, scale=0.5)))
    else:
        w = torch.exp(decay + rnd(b, t, h, hd, scale=0.5))
    u = rnd(h, hd, scale=0.1).to(dt)
    s0 = rnd(b, h, hd, hd, scale=0.1)
    log_w = torch.log(torch.clamp_min(w, 1e-38))
    y_want, s_want = ref.rwkv6_scan_ref(
        *(x.transpose(1, 2) for x in (r, k, v, log_w)), u, s0)
    before = ops.rwkv6_scan.launches
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    assert bool(torch.isfinite(y.float()).all()) and y.dtype == dt
    rtol = 3e-5 if dtype == "float32" else 8e-3
    scale = float(y_want.float().abs().max()) + 1e-6
    torch.testing.assert_close(y.float(), y_want.transpose(1, 2).float(),
                               rtol=0, atol=rtol * scale)
    torch.testing.assert_close(s, s_want, rtol=0,
                               atol=rtol * float(s_want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
def test_cuda_serve_matches_cpu(arch):
    """Reduced float32 serving on the card (its prefill through the kernel,
    once per layer) against the CPU (plain versions): tokens equal, logits
    to 1e-4 of their largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import dataclasses
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 32),
                            generator=torch.Generator().manual_seed(1))
    recs = {}
    for dev in ("cuda", "cpu"):
        args = serve.parse_args(["--device", dev, "--prompt-len", "32",
                                 "--gen-len", "8"])
        recs[dev] = serve.run(cfg, args,
                              params=tree_lib.tree_map(lambda a: a.to(dev),
                                                       params),
                              prompts=prompts.to(dev))
    kernel = "rwkv6_scan" if cfg.rwkv else "flash_attention"
    assert recs["cuda"]["prefill_launches"][kernel] == cfg.n_layers
    assert sum(recs["cuda"]["decode_launches"].values()) == 0
    assert torch.equal(recs["cuda"]["tokens"].cpu(), recs["cpu"]["tokens"])
    for key in ("prefill_logits", "replay_logits", "step_logits"):
        a, b = recs["cuda"][key].cpu(), recs["cpu"][key]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), key


def _to(obj, dev):
    """A state, tree or tuple of tensors moved to ``dev``."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, dev) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_to(v, dev) for v in obj)
    return obj


def _cuda_and_cpu_step(eng, state, data):
    """One step of ``eng`` from the same state and data (made on the CPU)
    on the card and on the CPU."""
    return {dev: eng.step(_to(state, dev), _to(data, dev))
            for dev in ("cuda", "cpu")}


@pytest.mark.cuda
def test_cuda_dppca_step_matches_cpu():
    """One D-PPCA step in float64 (nap, ring, probes on the [J, J] grid) on
    the card against the CPU: every field within 1e-10 of its largest
    magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.core import PenaltyConfig, build_graph
    from repro_torch.ppca import DPPCA, subspace_data
    x = torch.as_tensor(subspace_data(5, seed=0).x)
    eng = DPPCA(latent_dim=5, graph=build_graph("ring", 5),
                penalty_cfg=PenaltyConfig(scheme="nap", eta0=10.0))

    out = _cuda_and_cpu_step(
        eng, eng.init(x, torch.Generator().manual_seed(0)), x)
    (a, ma), (b, mb) = out["cuda"], out["cpu"]
    for f in ("W", "mu", "a", "Lam", "gam", "bet"):
        ga, gb = getattr(a, f).cpu(), getattr(b, f)
        assert float((ga - gb).abs().max()) <= 1e-10 * float(
            gb.abs().max()), f
    torch.testing.assert_close(a.penalty.eta.cpu(), b.penalty.eta,
                               rtol=1e-10, atol=0)
    torch.testing.assert_close(ma["objective"].cpu(), mb["objective"],
                               rtol=1e-10, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["nap", "vp"])
def test_cuda_admm_step_matches_cpu(scheme):
    """One ConsensusADMM step in float64 (the vmapped grad/vjp inner
    solver, the probes) on the card against the CPU: theta within 1e-10 of
    its largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.core import ConsensusADMM, PenaltyConfig, build_graph
    from repro_torch.examples.quickstart import lsq_problem, objective
    data, theta0, _ = lsq_problem(dtype=torch.float64)
    eng = ConsensusADMM(objective=objective,
                        penalty_cfg=PenaltyConfig(scheme=scheme, eta0=1.0),
                        graph=build_graph("ring", 8), inner_steps=30,
                        inner_lr=1.0)

    out = _cuda_and_cpu_step(eng, eng.init(theta0), data)
    (a, ma), (b, mb) = out["cuda"], out["cpu"]
    for f in ("theta", "lam"):
        ga, gb = getattr(a, f)["w"].cpu(), getattr(b, f)["w"]
        assert ga.dtype == torch.float64
        assert float((ga - gb).abs().max()) <= 1e-10 * float(
            gb.abs().max()), f
    torch.testing.assert_close(a.penalty.eta.cpu(), b.penalty.eta,
                               rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_probe_broadcast_at_scale_sfm_width():
    """The D-PPCA objective probes F[i, j] = nll_i(Theta_j) at the
    scale_sfm phase's width (5 cameras, 120 rows of 20,000 points, float64;
    the broadcast is 0.48 GB) on the card against the CPU, to 1e-10
    relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.ppca import PPCAParams, nll, turntable_sfm
    x = torch.as_tensor(turntable_sfm(5, frames=300, points=20000,
                                      seed=0).x_nodes)
    gen = torch.Generator().manual_seed(0)
    W = torch.randn((5, 20000, 3), generator=gen, dtype=torch.float64)
    mu = x.mean(dim=1)
    a = torch.rand(5, generator=gen, dtype=torch.float64) + 0.5
    got = {}
    for dev in ("cuda", "cpu"):
        p = PPCAParams(W[None].to(dev), mu[None].to(dev), a[None].to(dev))
        got[dev] = nll(p, x[:, None].to(dev)).cpu()
    assert got["cpu"].shape == (5, 5)
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_cuda_graphed_inner_solve_equals_eager():
    """On the card the engine replays its inner solver from a CUDA graph of
    the eager kernels: bit for bit the eager result, for new inputs on
    every call, and captured again when the data tensors change."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.core import ConsensusADMM, PenaltyConfig, build_graph
    from repro_torch.examples.quickstart import lsq_problem, objective
    eng = ConsensusADMM(objective=objective,
                        penalty_cfg=PenaltyConfig(scheme="vp", eta0=1.0),
                        graph=build_graph("ring", 8), inner_steps=30,
                        inner_lr=1.0)
    data, theta0, _ = lsq_problem(dtype=torch.float64, device="cuda")
    st = eng.init(theta0)
    adj, scale = eng._device_consts(st.penalty.eta.device)
    for _ in range(3):
        args = (data, st.theta, st.lam, st.penalty.eta * scale, adj)
        got = eng._solve_graphed(*args)
        assert torch.equal(got["w"], eng._solve_gradient(*args)["w"])
        st, _ = eng.step(st, data)
    assert len(eng._graphs) == 1
    data2 = tuple(t.clone() for t in data)
    args = (data2, st.theta, st.lam, st.penalty.eta * scale, adj)
    assert torch.equal(eng._solve_graphed(*args)["w"],
                       eng._solve_gradient(*args)["w"])
    assert len(eng._graphs) == 1


@pytest.mark.cuda
def test_cuda_ep_gloo_ranks_equal_one_process(tmp_path):
    """The expert-parallel paths as 2 gloo ranks sharing the card (a data 1
    x model 2 mesh, the all-to-all and the all-gathers staged through
    pinned host buffers): the MoE unit's all-to-all and replicated outputs
    and the served model's prefill and decode logits equal the one-process
    mesh's on the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import torch_ep_cases as ep
    from repro_torch.distributed import local_mesh
    from torch_ranks_cases import spawn
    shape = (1, 2)
    spawn(ep.ranks_worker, 2, tmp_path, str(tmp_path), "cuda", shape)
    p, x = ep.unit_on("cuda")
    params, toks = ep.served_on("cuda")
    want = ep.run_ep(local_mesh(*shape, "cuda"), p, x, params, toks)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["wg_shape"].tolist()[1] == 4
        for name in ("a2a", "repl", "prefill", "decode"):
            assert torch.equal(got[name], want[name].cpu()), (r, name)


@pytest.fixture(scope="module")
def cuda_inpod_ranks(tmp_path_factory):
    """``torch_inpod_cases.ranks_worker`` as 4 gloo ranks sharing the card,
    once for the module: its directory and the ranks' outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import torch_inpod_cases as cases
    from torch_ranks_cases import spawn
    d = tmp_path_factory.mktemp("cuda_inpod_ranks")
    spawn(cases.ranks_worker, 4, d, str(d), "cuda", timeout=600)
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(4)]


@pytest.mark.cuda
def test_cuda_inpod_gloo_ranks_equal_one_process(cuda_inpod_ranks):
    """The in-pod sharded local step as 4 gloo ranks sharing the card, at
    reduced size (``tests/torch_inpod_cases.py``): make_train_fns on a data
    2 x model 2 mesh (the gathers, reduce-scatters and all-to-alls staged
    through pinned host buffers) and the consensus trainer, J 2 with a
    data 1 x model 2 mesh a node; every rank's losses, norms, round
    metrics, parameter and moment shards and slabs equal one process's on
    the card bit for bit."""
    import torch_inpod_cases as cases
    from repro_torch.distributed import MeshStats, local_mesh, trivial_grid
    _, ranks = cuda_inpod_ranks
    stats = MeshStats()
    train = cases.run_train(local_mesh(*cases.RANKS_TRAIN_MESH, "cuda",
                                       stats=stats), cases.ARCH,
                            cases.TRAIN_CF, device="cuda", stats=stats)
    cases.assert_train_ranks_equal(ranks, train)
    cons = cases.run_consensus(trivial_grid(2, "cuda",
                                            mesh=cases.RANKS_CONS_MESH),
                               device="cuda")
    cases.assert_cons_ranks_equal(ranks, cons)


@pytest.mark.cuda
def test_cuda_replicated_ranks_equal_one_process(cuda_inpod_ranks, tmp_path):
    """The flat rows replicated in-pod on the 4 ranks sharing the card
    (J 2, data 1 x model 2 a node): the trainer's run and the launcher's
    async (int8, pipelined) and dynamic (fp8) runs equal one process on
    ``trivial_grid(2, mesh=(1, 2))`` on the card bit for bit, and the two
    in-pod ranks of each pod hold the same bits."""
    import torch_inpod_cases as cases
    from repro_torch.distributed import trivial_grid
    _, ranks = cuda_inpod_ranks
    grid = lambda: trivial_grid(2, "cuda", mesh=cases.RANKS_CONS_MESH)
    want = cases.run_consensus(grid(), device="cuda", obs=True, shard=False)
    cases.assert_rep_ranks_equal(ranks, want)
    for name in cases.PATH_RUNS:
        record, state = cases.traced_run(
            cases.cfg(cases.PATH_ARCH),
            cases.path_args(name, "cuda", str(tmp_path / name)), grid())
        one = dict(cases.record_numbers(record), **cases.state_rows(state))
        for rank, r in enumerate(ranks):
            got, pod = r["paths"][name], rank // 2
            assert got["losses"] == one["losses"]
            assert got["rounds"] == one["rounds"]
            for key in ("lam", "bar"):
                assert torch.equal(got[key], one[key][pod:pod + 1])
            for u, v in zip(got["replicated"], one["replicated"],
                            strict=True):
                assert torch.equal(u, v), (name, rank)
    for pod in range(2):
        a, b = ranks[2 * pod]["rep"], ranks[2 * pod + 1]["rep"]
        assert torch.equal(a["lam"], b["lam"])
        assert torch.equal(a["bar"], b["bar"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rows", "slabs", "inpod"])
def test_cuda_resume_on_ranks_equals_uninterrupted(cuda_inpod_ranks, name):
    """Through the launcher on the 4 ranks sharing the card: a run resumed
    from its step-2 checkpoint ends in the same checkpoint bytes as the
    uninterrupted run (blocks of rows, slabs, replicated in-pod shards)."""
    import torch_inpod_cases as cases
    d, ranks = cuda_inpod_ranks
    step = f"step_{cases.RESUME_STEPS:010d}"
    base = d / f"resume_{name}"
    cases.same_checkpoint(str(base / "full" / step),
                          str(base / "resumed" / step))
    for r in ranks:
        got = r["resume"][name]
        assert got["start_step"] == cases.RESUME_AT
        assert got["resumed"]["losses"] == \
            got["full"]["losses"][cases.RESUME_AT:]


@pytest.mark.cuda
def test_cuda_inpod_node_ring_sharded_equals_replicated():
    """On the card, the node ring of the sharded path (J 2 on the trivial
    grid with a data 1 x model 2 in-pod mesh, reduced qwen3-4b in float32)
    holds the replicated run's per-node residuals, probes and penalties
    (rtol 1e-4), as the reference's
    ``tests/test_obs.py::test_node_residuals_sharded_equals_replicated``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import torch_inpod_cases as cases
    from repro_torch.distributed import trivial_grid
    from repro_torch.obs.schema import NODE_COLUMN_INDEX
    runs = [cases.run_consensus(trivial_grid(2, "cuda", mesh=mesh),
                                device="cuda", obs=True, arch="qwen3-4b")
            for mesh in (cases.RANKS_CONS_MESH, None)]
    a, b = (r["node_ring"].cpu() for r in runs)
    cols = [NODE_COLUMN_INDEX[k] for k in ("r", "s", "f_local",
                                           "eta_row_mean", "alive")]
    assert bool((b[..., cols[0]] > 0).any())
    np.testing.assert_allclose(a[..., cols].numpy(), b[..., cols].numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-4b", "glm4-9b", "moonshot",
                                  "musicgen", "rwkv6-7b", "qwen3-4b-seq",
                                  "qwen3-4b-window"])
def test_cuda_tp_serve_matches_cpu(name):
    """Tensor-parallel serving on the card: each case of
    ``tests/torch_tp_cases.py`` on its one-process mesh, float32, from one
    seed's weights, against the same on the CPU (which
    ``tests/test_torch_tp_serve.py`` holds against the reference): the
    prefill's and the decode steps' logits within 1e-4 of max|logit|; and
    the prefill with ``use_kernel`` (the flash kernel, or the scan, on each
    model shard's heads) within the same bound of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import torch_tp_cases as tp
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import local_mesh
    shape = tp.SERVE_CASES[name][1]
    cfg = tp.port_cfg(name)
    model, params = tp.drawn(name)
    want = tp.run_serve(model, local_mesh(*shape, "cpu"), params,
                        tp.torch_inputs(cfg), tp.steps_of(name))
    on_card = tree_lib.tree_map(lambda x: x.cuda(), params)
    for use_kernel in (False, True):
        before = ops.flash_attention.launches + ops.rwkv6_scan.launches
        got = tp.run_serve(model, local_mesh(*shape, "cuda"), on_card,
                           tp.torch_inputs(cfg, "cuda"), tp.steps_of(name),
                           use_kernel=use_kernel)
        launched = ops.flash_attention.launches + ops.rwkv6_scan.launches \
            - before
        assert launched == (cfg.n_layers * shape[0] * shape[1]
                            if use_kernel else 0)
        for what in ("prefill", "decode"):
            w = want[what].numpy()
            np.testing.assert_allclose(
                got[what].cpu().numpy(), w, rtol=0,
                atol=1e-4 * float(np.abs(w).max()), err_msg=what)


@pytest.mark.cuda
def test_cuda_tp_gloo_ranks_equal_one_process(tmp_path):
    """Tensor-parallel serving as 4 gloo ranks sharing the card (a data 2
    x model 2 mesh, the gathers staged through pinned host buffers), each
    holding its shards only: every rank's prefill and decode logits equal
    the one-process mesh's on the card bit for bit, and its parameter
    bytes are its shards'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import torch_tp_cases as tp
    from repro_torch.distributed import fsdp, local_mesh
    from torch_ranks_cases import spawn
    spawn(tp.ranks_worker, 4, tmp_path, str(tmp_path), "cuda",
          timeout=600)
    mesh = local_mesh(*tp.RANKS_MESH, "cuda")
    for name in tp.RANKS_CASES:
        model, params = tp.drawn(name, "cuda")
        want = tp.run_serve(model, mesh, params,
                            tp.torch_inputs(tp.port_cfg(name), "cuda"),
                            tp.steps_of(name))
        for r in range(4):
            got = torch.load(tmp_path / f"rank{r}.pt")
            for what in ("prefill", "decode"):
                assert torch.equal(got[f"{name}/{what}"],
                                   want[what].cpu()), (r, name, what)
            assert int(got[f"{name}/param_bytes"]) == \
                fsdp.shard_bytes(model, mesh)["params"]
