"""The port's plain flash attention against the reference's Pallas kernel.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``): its
Pallas ``flash_attention`` in interpret mode, its oracle
``kernels.ref.flash_attention_ref`` and its model-layout
``models.attention.flash_ref``, on inputs both sides draw from the numpy
generators below (bf16 inputs rounded to bf16 through f32 on both sides).

Tolerances are the reference's own (``tests/test_kernels.py``): atol 2e-5
in float32, 2e-2 in bf16 (the plain version rounds the logits and the
probabilities to bf16 where the kernel keeps f32).

The card's "cc" kernel (``csrc/flash_attention.cu``) takes its products on
the tensor cores in TF32, each f32 operand split into two TF32 parts. Its
arithmetic is emulated here in numpy (TF32 rounding as ``cvt.rna`` on the
bit pattern for the high part, the low part truncated as the tensor cores
read it, a_lo b_lo dropped, its key tiles and base-2 online softmax) and
held to the plain version at the f32 tolerance; one TF32 part a product
misses it, so the test guards the split. ``plan``'s copy width for that
kernel is checked on aligned and misaligned views.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from torch_round_cases import bf16_round, run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

# (b, h, kv heads, s, hd, causal, window, block_q, block_k): the reference's
# tests/test_kernels.py cases, then the zoo's other head dims; the blocks
# are the Pallas kernel's tiling
CASES = [
    (1, 2, 2, 128, 32, True, 0, 64, 64),
    (2, 4, 2, 256, 64, True, 0, 128, 128),
    (1, 4, 1, 256, 32, True, 64, 64, 64),
    (1, 2, 2, 128, 32, False, 0, 32, 64),
    (1, 8, 2, 128, 128, True, 0, 128, 64),
    # the zoo's head dims: stablelm-3b's 80 (MHA) and kimi-k2's 112 (GQA,
    # with a window)
    (1, 4, 4, 128, 80, True, 0, 64, 64),
    (1, 8, 1, 128, 112, True, 48, 64, 64),
    # the edges of the tensor-core kernel's padded tile at hd 80 and 112:
    # GQA 8/2, S 200 (not a multiple of its 128 rows; the Pallas kernel
    # tiles it by 40), and a window of 100, under its 128-key tile; then
    # the card tests' shapes: S 96 (below one tile) at both widths, and
    # GQA with a window of 40 at hd 112
    (1, 8, 2, 128, 80, True, 0, 64, 64),
    (1, 2, 2, 200, 80, True, 0, 40, 40),
    (1, 4, 2, 256, 112, True, 100, 128, 128),
    (2, 4, 4, 96, 80, True, 0, 96, 96),
    (2, 4, 2, 96, 112, True, 0, 96, 96),
    (1, 8, 1, 256, 112, True, 40, 128, 128),
]
DTYPES = ("float32", "bfloat16")
# model layout [B, S, H, hd]: (causal, window, kv heads) with 4 query heads
MODEL_CASES = [(True, 0, 4), (True, 48, 4), (True, 0, 2), (False, 0, 1)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _case_id(case):
    return "-".join(str(x) for x in case)


def _inputs(n, case, dtype):
    """q [B,H,S,hd], k/v [B,K,S,hd] as float32 numpy (bf16-exact for
    bfloat16)."""
    b, h, kh, s, hd = case[:5]
    rng = np.random.default_rng(n)
    out = [rng.normal(size=shape).astype(np.float32)
           for shape in ((b, h, s, hd), (b, kh, s, hd), (b, kh, s, hd))]
    return [bf16_round(x) for x in out] if dtype == "bfloat16" else out


def _model_inputs(n, kv):
    rng = np.random.default_rng(100 + n)
    b, s, h, hd = 2, 128, 4, 32
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


def _reference_outputs():
    """The reference's Pallas kernel (interpret mode), its oracle and its
    model-layout flash_ref (runs with JAX)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as fa_raw
    from repro.models.attention import flash_ref as model_ref

    out = {}
    for n, case in enumerate(CASES):
        _, h, kh, _, _, causal, window, bq, bk = case
        for dtype in DTYPES:
            q, k, v = (jnp.asarray(x, getattr(jnp, dtype))
                       for x in _inputs(n, case, dtype))
            key = f"{_case_id(case)}/{dtype}"
            out[f"pallas/{key}"] = np.asarray(
                fa_raw(q, k, v, causal=causal, window=window, block_q=bq,
                       block_k=bk, interpret=True), np.float32)
            kr, vr = jnp.repeat(k, h // kh, 1), jnp.repeat(v, h // kh, 1)
            out[f"oracle/{key}"] = np.asarray(jref.flash_attention_ref(
                q, kr, vr, causal=causal, window=window), np.float32)
    for n, (causal, window, kv) in enumerate(MODEL_CASES):
        q, k, v = map(jnp.asarray, _model_inputs(n, kv))
        k, v = jnp.repeat(k, 4 // kv, 2), jnp.repeat(v, 4 // kv, 2)
        out[f"model/{n}"] = np.asarray(model_ref(q, k, v, causal=causal,
                                                 window=window))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_flash_attention", tmp_path_factory)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_flash_matches_pallas_and_oracle(reference, case, dtype):
    """The plain version (K/V repeated to the query heads) and the
    head-major wrapper's CPU path (which repeats them itself) against the
    Pallas kernel and the reference's oracle. The wrapper refuses an S
    that is not a multiple of min(128, S), as the reference's wrapper
    does; at such an S only the kernel, called directly, meets the plain
    version (tests/test_torch_cuda.py)."""
    n = CASES.index(case)
    _, h, kh, s, _, causal, window, _, _ = case
    q, k, v = (_torch(x, dtype) for x in _inputs(n, case, dtype))
    kr = k.repeat_interleave(h // kh, dim=1)
    vr = v.repeat_interleave(h // kh, dim=1)
    plain = ref.flash_attention_ref(q, kr, vr, causal=causal, window=window)
    outs = [plain]
    if s % min(ops.ATTN_BLOCK, s):
        with pytest.raises(ValueError, match="multiple of the block"):
            ops.flash_attention_hmajor(q, k, v, causal=causal, window=window)
    else:
        outs.append(ops.flash_attention_hmajor(q, k, v, causal=causal,
                                               window=window))
    assert all(x.dtype == q.dtype for x in outs)
    key = f"{_case_id(case)}/{dtype}"
    for got in outs:
        for want in ("pallas", "oracle"):
            np.testing.assert_allclose(got.float().numpy(),
                                       reference[f"{want}/{key}"],
                                       atol=TOL[dtype], err_msg=want)


@pytest.mark.parametrize("n", range(len(MODEL_CASES)),
                         ids=[f"causal{c}-w{w}-kv{k}"
                              for c, w, k in MODEL_CASES])
def test_model_layout_wrapper_matches_flash_ref(reference, n):
    """``ops.flash_attention`` ([B, S, H, hd], GQA by the kernel's head
    index) against the reference's model-layout ``flash_ref`` on K/V
    repeated by the model's own rule."""
    causal, window, kv = MODEL_CASES[n]
    q, k, v = map(torch.from_numpy, _model_inputs(n, kv))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.flash_attention.launches == before     # the CPU: no kernel
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), reference[f"model/{n}"],
                               atol=2e-5)


def test_flash_refuses_a_ragged_sequence():
    """S must be a multiple of min(128, S), as the reference asserts."""
    q = torch.zeros(1, 136, 2, 16)
    with pytest.raises(ValueError, match="not a multiple of the block"):
        ops.flash_attention(q, q, q)
    # below one block, any length is one block
    assert ops.flash_attention(q[:, :24], q[:, :24], q[:, :24]).shape \
        == (1, 24, 2, 16)


def test_flash_has_no_path_off_the_cpu_and_the_card():
    q = torch.zeros(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q, q, q)
    c = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="not on a CUDA card"):
        fa_kernel.launch(c, c, c, causal=True, window=0)


# -- the "cc" kernel's arithmetic: mma.sync in TF32 parts -------------------
EMU_HEAD_DIMS = (16, 32, 64, 80, 112, 128)


def tf32(x):
    """cvt.rna.tf32.f32 on the bit pattern: round the f32 magnitude to 10
    mantissa bits, ties away from zero (finite x)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(x):
    """A TF32 operand as the tensor cores read an f32 bit pattern: the low
    13 bits dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_product(a, b, parts, a_exact=False, b_exact=False):
    """a @ b as the kernel takes it: f32 sums of TF32 products, each f32
    operand split as x = hi + lo (hi = tf32(x), lo = x - hi, read by the
    tensor cores as tf32_trunc(lo)) and the terms a_lo b_hi + a_hi b_lo +
    a_hi b_hi summed in that order (a_lo b_lo dropped); an exact operand
    (bf16 widened: a TF32 number) has no low part; ``parts`` 1 takes
    a_hi b_hi alone. A product of two TF32 numbers is exact in f32."""
    a_hi, b_hi = tf32(a), tf32(b)
    if parts == 1:
        return a_hi @ b_hi
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    if not a_exact:
        out += tf32_trunc(a - a_hi) @ b_hi
    if not b_exact:
        out += a_hi @ tf32_trunc(b - b_hi)
    return out + a_hi @ b_hi


def emulate_cc_kernel(q, k, v, *, parts, exact, key_tile, causal=True):
    """The "cc" kernel on [H, S, hd] f32 numpy inputs: key tiles of
    ``key_tile`` rows, S = Q K^T (``exact``: q and k are TF32 numbers, one
    product a term), logits scaled by log2(e) / sqrt(hd) in f32, masked at
    -1e30, the online softmax in base 2 in f32, O += P V (p split, v exact
    when ``exact``), and out = acc / max(l, 1e-30)."""
    h, s, hd = q.shape
    scale = np.float32(np.float32(1.4426950408889634)
                       / np.sqrt(np.float32(hd)))
    m = np.full((h, s, 1), -1e30, np.float32)
    l = np.zeros((h, s, 1), np.float32)
    acc = np.zeros((h, s, hd), np.float32)
    qpos = np.arange(s)[:, None]
    for k0 in range(0, s, key_tile):
        kt, vt = k[:, k0:k0 + key_tile], v[:, k0:k0 + key_tile]
        logits = tf32_product(q, kt.transpose(0, 2, 1), parts,
                              b_exact=exact, a_exact=exact) * scale
        kpos = np.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            logits = np.where(kpos <= qpos, logits, np.float32(-1e30))
        m_new = np.maximum(m, logits.max(-1, keepdims=True))
        alpha = np.exp2(m - m_new)
        p = np.exp2(logits - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        acc = acc * alpha + tf32_product(p, vt, parts, b_exact=exact)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


@pytest.mark.parametrize("mode", ["f32, three parts", "bf16 operands",
                                  "f32, one part"])
@pytest.mark.parametrize("hd", EMU_HEAD_DIMS)
def test_cc_kernel_tf32_arithmetic_holds_f32_tolerance(hd, mode):
    """Three TF32 parts a product (bf16 operands unsplit) keep the "cc"
    kernel within the f32 tolerance 2e-5 of the plain version at every
    head dim; one part misses it (1 head of 4 x S 256, causal)."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.normal(size=(4, 256, hd)).astype(np.float32)
               for _ in range(3))
    exact = mode == "bf16 operands"
    if exact:
        q, k, v = (bf16_round(x) for x in (q, k, v))
    key_tile = 32 if hd >= 80 and not exact else 64
    got = emulate_cc_kernel(q, k, v, parts=1 if "one" in mode else 3,
                            exact=exact, key_tile=key_tile)
    want = ref.flash_attention_ref(*(torch.from_numpy(x)[None]
                                     for x in (q, k, v)),
                                   causal=True, window=0)[0].numpy()
    err = float(np.abs(got - want).max())
    if "one" in mode:
        assert err > TOL["float32"], err
    else:
        assert err <= TOL["float32"], err


def test_every_finite_bf16_is_a_tf32_number():
    """bf16 widened to f32 keeps 7 mantissa bits: TF32 rounding (10 bits)
    leaves every finite one unchanged, so the kernel's bf16 operands need
    no split."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    finite = bits[np.isfinite(bits)]
    assert finite.size == (1 << 16) - 2 * 128     # all but inf and NaN
    assert np.array_equal(tf32(finite).view(np.uint32),
                          finite.view(np.uint32))


def _view(shape, dtype, offset):
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=dtype)[offset:offset + n].view(shape)


@pytest.mark.parametrize("dtype,offset,layout,copy", [
    (torch.float32, 0, "bhsd", 16), (torch.float32, 0, "bshd", 16),
    (torch.float32, 1, "bhsd", 4), (torch.float32, 2, "bshd", 4),
    (torch.bfloat16, 0, "bhsd", 16), (torch.bfloat16, 2, "bhsd", 4),
    (torch.bfloat16, 1, "bhsd", 2), (torch.bfloat16, 3, "bshd", 2)])
def test_flash_plan_reports_the_cc_copy_width(dtype, offset, layout, copy):
    """16-byte copies when every row of q, k and v starts 16-byte aligned,
    4-byte ones when 4-byte aligned, plain loads for bf16 rows at an odd
    element; a tensor map of the tensor-core route reports none."""
    shape = (2, 4, 64, 32) if layout == "bhsd" else (2, 64, 4, 32)
    q = _view(shape, dtype, offset)
    ok = torch.zeros(shape, dtype=dtype)
    p = fa_kernel.plan(q, ok, ok, window=0, layout=layout)
    assert p["route"] == "cc" and p["copy_bytes"] == copy
    # every row must be aligned: an aligned q with a misaligned v
    assert fa_kernel.plan(ok, ok, q, window=0,
                          layout=layout)["copy_bytes"] == copy
    tc = torch.zeros(shape[:3] + (128,), dtype=torch.bfloat16)
    assert fa_kernel.plan(tc, tc, tc, window=0,
                          layout=layout)["copy_bytes"] is None


def test_flash_plan_cc_copy_width_follows_the_strides():
    """Rows of 36 floats cut to 32 start 16-byte aligned (144-byte
    stride); rows of 33 floats cut to 32 only 4-byte aligned; a dim of
    size 1 is never stepped, so its stride does not count."""
    q = torch.zeros(1, 64, 2, 36)[..., :32]
    assert fa_kernel.plan(q, q, q, window=0)["copy_bytes"] == 16
    q = torch.zeros(1, 64, 2, 33)[..., :32]
    assert fa_kernel.plan(q, q, q, window=0)["copy_bytes"] == 4
    q = torch.zeros(64 * 2 * 32).as_strided((1, 64, 2, 32), (5, 64, 32, 1))
    assert fa_kernel.plan(q, q, q, window=0)["copy_bytes"] == 16
