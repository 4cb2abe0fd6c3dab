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
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from torch_round_cases import bf16_round, run_reference

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
