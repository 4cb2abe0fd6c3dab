"""The kernels' dispatch rules and argument checks, and the SASS counter
that ``chip_smoke.py`` reads a build with: all of it plain Python that runs
before any kernel is built, so it is tested here on the CPU.

* ``kernels.flash_attention.route`` sends bf16 at head dim 64, 80, 112 or
  128 to the tensor-core kernel and everything else (float32 at every head
  dim, and bf16 at head dim 16 or 32) to the CUDA-core one.
* ``flash_attention.plan`` and ``rwkv6_scan.plan`` refuse what their
  kernel does not take (a 16-byte-misaligned tensor for the tensor-core
  kernel's TMA, a head dim or a chunk outside the compiled ones) with a
  ValueError, and never reach the build.
* ``build.sass_counts`` counts the tensor-core, asynchronous-copy and
  mbarrier instructions of each kernel in canned ``cuobjdump -sass`` text.
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_scan as rw


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything asks for a kernel build."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel build was asked for")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "build", refuse)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "cc"), (torch.bfloat16, 16, "cc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 112, "tc"),
    (torch.float32, 128, "cc"), (torch.float32, 64, "cc"),
    (torch.float32, 80, "cc"), (torch.float16, 128, "cc"),
    (torch.float32, 112, "cc"), (torch.float32, 32, "cc"),
    (torch.float32, 16, "cc")])
def test_flash_route_rule(dtype, hd, want):
    assert fa.route(dtype, hd) == want


@pytest.mark.parametrize("hd", [80, 112])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_plan_takes_the_zoo_head_dims(no_build, hd, dtype):
    """stablelm-3b's hd 80 and kimi-k2's 112 (GQA 64/8 in the model layout)
    go to the tensor-core kernel in bf16 and to the CUDA-core one in
    float32, by rule."""
    q = torch.zeros(2, 128, 64, hd, dtype=dtype)
    k = torch.zeros(2, 128, 8, hd, dtype=dtype)
    p = fa.plan(q, k, k, window=0)
    want = "tc" if dtype == torch.bfloat16 else "cc"
    assert p["route"] == want and (p["h"], p["kv"], p["hd"]) == (64, 8, hd)


@pytest.mark.parametrize("hd,h,kv", [(80, 32, 32), (112, 64, 8)])
def test_flash_plan_zoo_model_layout_passes_tma_checks(no_build, hd, h, kv):
    """stablelm-3b's [B, S, 32, 80] and kimi-k2's [B, S, 64, 112] (8 KV
    heads) in the model layout: bf16 routes to the tensor-core kernel, and
    their strides (hd and H x hd elements, multiples of 8) pass its TMA
    checks as they are."""
    b, s = 2, 512
    q = torch.zeros(b, s, h, hd, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kv, hd, dtype=torch.bfloat16)
    p = fa.plan(q, k, k, window=0)
    assert p["route"] == "tc" and (p["b"], p["s"], p["h"], p["kv"],
                                   p["hd"]) == (b, s, h, kv, hd)
    assert p["strides"][0] == [s * h * hd, h * hd, hd]
    assert p["strides"][1] == p["strides"][2] == [s * kv * hd, kv * hd, hd]


def _misaligned(shape, dtype, offset=1):
    """A view of ``shape`` that starts ``offset`` elements into a buffer."""
    n = 1
    for x in shape:
        n *= x
    buf = torch.zeros(n + 16, dtype=dtype)
    return buf[offset:offset + n].view(shape)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_plan_routes_and_takes_aligned_model_tensors(layout):
    q = torch.zeros(2, 256, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 256, 2, 128, dtype=torch.bfloat16)
    if layout == "bhsd":
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    p = fa.plan(q, k, k, window=0, layout=layout)
    assert p["route"] == "tc" and (p["b"], p["s"], p["h"], p["kv"],
                                   p["hd"]) == (2, 256, 8, 2, 128)
    assert p["strides"][0] == [256 * 8 * 128, 8 * 128, 128]


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_plan_refuses_misaligned_bf16(no_build, layout):
    shape = (1, 128, 2, 128) if layout == "bshd" else (1, 2, 128, 128)
    q = _misaligned(shape, torch.bfloat16)
    ok = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.plan(q, ok, ok, window=0, layout=layout)
    # float32 takes the CUDA-core kernel, which reads element by element
    q32 = _misaligned(shape, torch.float32)
    ok32 = ok.float()
    assert fa.plan(q32, ok32, ok32, window=0, layout=layout)["route"] == "cc"


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_plan_refuses_misaligned_bf16_at_hd80(no_build, layout):
    """hd 80 routes to the tensor-core kernel: a base off 16 bytes raises,
    it is not sent to the CUDA-core kernel (which would read it)."""
    shape = (2, 128, 4, 80) if layout == "bshd" else (2, 4, 128, 80)
    q = _misaligned(shape, torch.bfloat16)
    ok = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.plan(q, ok, ok, window=0, layout=layout)
    assert fa.plan(q, ok, ok, window=0, layout=layout,
                   route_to="cc")["route"] == "cc"


def test_flash_plan_refuses_strides_off_16_bytes_at_hd80(no_build):
    """Heads of 84 bf16 cut to 80: a head stride of 168 bytes, not a
    multiple of 16, raises; only the timing override reaches the
    CUDA-core kernel with it."""
    q = torch.zeros(2, 64, 2, 84, dtype=torch.bfloat16)[..., :80]
    ok = torch.zeros(2, 64, 2, 80, dtype=torch.bfloat16)
    assert fa.route(q.dtype, 80) == "tc"
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.plan(q, ok, ok, window=0)
    assert fa.plan(q, ok, ok, window=0, route_to="cc")["route"] == "cc"


def test_flash_plan_refuses_strides_off_16_bytes(no_build):
    # rows of 130 bf16: a 260-byte stride, not a multiple of 16 bytes
    q = torch.zeros(1, 64, 2, 130, dtype=torch.bfloat16)[..., :128]
    ok = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.plan(q, ok, ok, window=0)


def test_flash_plan_ignores_strides_of_size_one_dims():
    # a batch of one may carry any batch stride: TMA never steps it
    q = torch.zeros(3, 64, 2, 128, dtype=torch.bfloat16)[1:2]
    assert fa.plan(q, q, q, window=0)["route"] == "tc"
    assert fa._tma_strides(q, (0, 1, 2))[0] % 8 == 0


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "heads", "window",
                                 "layout"])
def test_flash_plan_argument_checks(no_build, bad):
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    v = k
    kw = dict(window=0, layout="bshd")
    if bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (48,), dtype=t.dtype)
                   for t in (q, k, v))
    elif bad == "dtype":
        k = k.float()
    elif bad == "heads":
        k = v = torch.zeros(1, 64, 3, 64, dtype=torch.bfloat16)
    elif bad == "window":
        kw["window"] = -1
    else:
        kw["layout"] = "sbhd"
    with pytest.raises(ValueError, match="flash_attention kernel"):
        fa.plan(q, k, v, **kw)


def test_flash_launch_refuses_cpu_tensors(no_build):
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not on a CUDA card"):
        fa.launch(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="kernel"):
        fa.launch(q, q, q, causal=True, window=0, kernel="tc")


def _scan_inputs(t=64, h=2, hd=64, dtype=torch.bfloat16):
    r = torch.zeros(1, t, h, hd, dtype=dtype)
    log_w = torch.zeros(1, t, h, hd)
    return r, r, r, log_w, torch.zeros(h, hd), torch.zeros(1, h, hd, hd)


@pytest.mark.parametrize("case", ["chunk", "head_dim", "multiple"])
def test_scan_plan_argument_checks(no_build, case):
    t = 256 if case == "chunk" else 64
    r, k, v, log_w, u, s0 = _scan_inputs(t=t, hd=48 if case == "head_dim"
                                         else 64)
    chunk = {"chunk": 128, "multiple": 48}.get(case, 32)
    match = {"chunk": "takes 1 to 64", "head_dim": "head dim",
             "multiple": "not a multiple"}[case]
    with pytest.raises(ValueError, match=match):
        rw.plan(r, k, v, log_w, u, s0, chunk=chunk)


def test_scan_plan_tma_only_for_aligned_rows():
    r, k, v, log_w, u, s0 = _scan_inputs()
    assert rw.plan(r, k, v, log_w, u, s0, chunk=32)["tma"]
    # rows of 65 bf16 (130 bytes) cannot be copied by TMA: plain loads
    r = torch.zeros(1, 64, 2, 65, dtype=torch.bfloat16)[..., 1:]
    assert not rw.plan(r, k, v, log_w, u, s0, chunk=32)["tma"]


def test_scan_launch_refuses_cpu_tensors(no_build):
    with pytest.raises(ValueError, match="not on a CUDA card"):
        rw.launch(*_scan_inputs(), chunk=32)


def test_scan_strides_of_size_one_dims():
    x = torch.zeros(3, 64, 2, 64)[1:2]         # batch stride of the buffer
    sts = rw._strides(x)
    assert sts[1:] == [64, 2 * 64] and sts[0] % 8 == 0


SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

\tcode for sm_90a
\t\tFunction : _ZN54_GLOBAL__N__d43d1596_21_flash_attention_tc_cu_4a343a6425flash_attention_tc_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_6TcArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0300*/                   SYNCS.EXCH.64 URZ, [UR10+0x28000], UR6 ;  /* 0x028000060a3f75b2 */
        /*0310*/                   UTMALDG.4D [UR8], [UR4] ;                  /* 0x00000008040075b4 */
        /*0500*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+URZ+0x28020], RZ ; /* 0x028020ff030075a7 */
        /*0ad0*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ; /* 0x0000000418187df0 */
        /*0ae0*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ; /* 0x0000000818187df0 */
        /*0af0*/              @!P0 BRA 0x500 ;                                /* 0xfffffffc00008947 */
        /*0b00*/                   EXIT ;                                     /* 0x000000000000794d */
\t\t..........

\t\tFunction : _ZN46_GLOBAL__N__137faf98_13_rwkv6_scan_cu_f26dcbe317rwkv6_scan_kernelI13__nv_bfloat16Li64ELi32EEEv14CUtensorMap_stS1_S1_S1_NS_8ScanArgsE
        /*0010*/                   LDGSTS.E.128 [R3], desc[UR4][R4.64] ;      /* 0x0000000004037fae */
        /*0020*/              @!P1 LDGSTS.E.128 [R3+0x10], desc[UR4][R4.64+0x10] ; /* 0x0000100004037fae */
        /*0030*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;     /* 0x000000100c08723c */
        /*0040*/                   FFMA R1, R2, R3, R1 ;                      /* 0x0000000302017223 */
        /*10040*/                  UTMALDG.4D [UR8], [UR4] ;                  /* 0x00000008040075b4 */
\t\t..........
"""


def test_sass_counts_on_canned_cuobjdump_text():
    got = build.sass_counts(SASS)
    assert got == {
        "flash_attention_tc_kernel<128>": dict(
            HGMMA=2, HMMA=0, UTMALDG=1, LDGSTS=0, SYNCS=2),
        "rwkv6_scan_kernel<bf16,64,32>": dict(
            HGMMA=0, HMMA=1, UTMALDG=1, LDGSTS=2, SYNCS=0)}


@pytest.mark.parametrize("mangled,short", [
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea722flash_"
     "attention_kernelIfLi128EEEvNS_9FlashArgsE",
     "flash_attention_kernel<float,128>"),
    ("_ZN46_GLOBAL__N__137faf98_13_rwkv6_scan_cu_f26dcbe317rwkv6_scan_"
     "kernelI13__nv_bfloat16Li16ELi8EEEvNS_8ScanArgsE",
     "rwkv6_scan_kernel<bf16,16,8>"),
    ("consensus_round_launch", "consensus_round_launch")])
def test_short_kernel_name(mangled, short):
    assert build.short_kernel_name(mangled) == short
