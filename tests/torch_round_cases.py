"""Helpers shared by the port's tests: the inputs of one fused consensus
round (used by the CPU parity tests and the card's tests), a runner that
computes the reference's outputs in a fresh process, and the fixture that
runs a test module's torch on one thread. This module imports no JAX, so
it also runs on a machine without it."""
import fcntl
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch while the importing test module runs, then
    the count it had. The xdist workers and the reference's processes share
    the cores, and a test process on every core beside them ran the port's
    CPU work many times slower than alone (a D-PPCA run of 4.5 s alone took
    133 s in a full run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NAMES = ("theta", "lam", "bar", "r_sq", "s_sq")
ARGS = ("theta", "lam", "barp", "wires", "scales", "e_sym", "alpha",
        "eta_sum", "eta_node")


def round_case(rng, *, j, deg, nleaves, bs):
    """The reference's ``tests/test_kernels.py::_round_case`` generator."""
    sizes = [int(rng.integers(1, 4 * bs)) for _ in range(nleaves)]
    padded = [-(-s // bs) * bs for s in sizes]
    total = sum(padded)
    block_leaf, pieces = [], []
    for li, (s, p) in enumerate(zip(sizes, padded)):
        block_leaf += [li] * (p // bs)
        seg = np.zeros((j, p), np.float32)
        seg[:, :s] = rng.normal(size=(j, s))
        pieces.append(seg)
    theta = np.concatenate(pieces, axis=1)
    lam = rng.normal(size=(j, total)).astype(np.float32)
    barp = rng.normal(size=(j, total)).astype(np.float32)
    wires = rng.integers(-127, 128, size=(deg, j, total)).astype(np.int8)
    scales = rng.uniform(1e-3, 0.1, size=(deg, j, nleaves)).astype(np.float32)
    e_sym = rng.uniform(0.1, 3.0, size=(deg, j)).astype(np.float32)
    eta_sum = e_sym.sum(axis=0)
    alpha = (0.5 / (1.0 + 2.0 * eta_sum)).astype(np.float32)
    eta_node = (eta_sum / deg).astype(np.float32)
    return dict(theta=theta, lam=lam, barp=barp, wires=wires, scales=scales,
                e_sym=e_sym, alpha=alpha, eta_sum=eta_sum, eta_node=eta_node,
                block_leaf=np.asarray(block_leaf, np.int32))


FP8_DTYPES = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def fp8_bytes(rng, shape, fmt):
    """Random fp8 codes of format ``fmt`` (``fp8_e4m3`` or ``fp8_e5m2``) as
    int8: every finite value, subnormals included; the NaN (and e5m2's
    infinity) codes are moved to the largest finite magnitude."""
    u = rng.integers(0, 256, size=shape).astype(np.uint8)
    if fmt == "fp8_e4m3":                   # e4m3fn: S.1111.111 is NaN
        u[(u & 0x7F) == 0x7F] ^= 0x01
    else:                                   # e5m2: S.11111.xx inf / NaN
        u[(u & 0x7C) == 0x7C] &= 0xFB
    return u.view(np.int8)


def fp8_scales(rng, shape, fmt):
    """Per-block scales [deg, J, num_blocks] for fp8 codes: the int8 case's
    1e-3 .. 0.1 per int8 step, over the fp8 format's range, so that the
    dequantized wires span what ``round_case``'s int8 wires span (up to
    12.7), as an absmax codec makes them."""
    fp8_max = 448.0 if fmt == "fp8_e4m3" else 57344.0
    return (rng.uniform(1e-3, 0.1, size=shape) * 127.0 / fp8_max).astype(
        np.float32)


def fp8_round_case(rng, *, j, deg, nleaves, bs, fmt):
    """``round_case`` with an fp8 wire: fp8 codes (in an int8 container,
    see ``fp8_bytes``) and per-block scales [deg, J, num_blocks]."""
    case = round_case(rng, j=j, deg=deg, nleaves=nleaves, bs=bs)
    case["wires"] = fp8_bytes(rng, case["wires"].shape, fmt)
    nblocks = case["block_leaf"].shape[0]
    case["scales"] = fp8_scales(rng, (deg, j, nblocks), fmt)
    case["wire_kind"] = fmt
    return case


def torch_args(case):
    out = []
    for k in ARGS:
        a = np.ascontiguousarray(case[k])
        if a.dtype.name == "bfloat16":      # same bits through int16
            out.append(torch.from_numpy(a.view(np.int16).copy())
                       .view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a))
    if case.get("wire_kind") in FP8_DTYPES:     # fp8 codes: same bits
        out[3] = out[3].view(FP8_DTYPES[case["wire_kind"]])
    return out


def bf16_round(x):
    """``x`` rounded to the nearest bfloat16, kept as float32 numpy (so that
    either framework casts it to bf16 exactly)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def masked_round_case(rng, *, j, deg, nleaves, bs, wire="int8",
                      theta_dtype="float32", kick=True):
    """An edge-gated round's inputs, as the dynamic trainer builds them.

    Gates mixed 0/1 with: node ``j - 1`` a ghost (no gate, ``inv_deg`` 0);
    offset 0 dead for every node (zero payload, unit scales, no gate); the
    gated edges' weights zero in ``e_sym``; with ``kick``, non-zero kick
    weights on the gated edges of live offsets. ``wire`` is ``int8``,
    ``native`` (theta's dtype) or an fp8 format (``fp8_e4m3``,
    ``fp8_e5m2``: fp8 codes and per-block scales, see ``fp8_round_case``);
    ``theta_dtype`` is ``float32`` or
    ``bfloat16`` (values rounded to bf16 and stored as float32, see
    ``masked_torch_args``).
    """
    case = round_case(rng, j=j, deg=deg, nleaves=nleaves, bs=bs)
    bar_w = rng.integers(0, 2, size=(deg, j)).astype(np.float32)
    bar_w[:, j - 1] = 0.0                          # ghost row
    bar_w[0, :] = 0.0                              # dead offset
    if deg > 1:
        bar_w[1, 0] = 1.0                          # some live edge
    if wire == "native":
        case["wires"] = rng.normal(size=case["wires"].shape).astype(
            np.float32)
        case["scales"] = np.ones_like(case["scales"])
    elif wire in FP8_DTYPES:
        nblocks = case["block_leaf"].shape[0]
        case["wires"] = fp8_bytes(rng, case["wires"].shape, wire)
        case["scales"] = fp8_scales(rng, (deg, j, nblocks), wire)
    case["wires"][0] = 0
    case["scales"][0] = 1.0
    if theta_dtype == "bfloat16":
        case["theta"] = bf16_round(case["theta"])
        if wire == "native":
            case["wires"] = bf16_round(case["wires"])
    e_sym = case["e_sym"] * bar_w
    act = bar_w.sum(axis=0)
    inv_deg = np.where(act > 0, 1.0 / np.maximum(act, 1.0), 0.0).astype(
        np.float32)
    eta_sum = e_sym.sum(axis=0)
    case.update(e_sym=e_sym, eta_sum=eta_sum,
                alpha=(0.5 / (1.0 + 2.0 * eta_sum)).astype(np.float32),
                eta_node=(eta_sum * inv_deg).astype(np.float32),
                bar_w=bar_w, inv_deg=inv_deg, theta_dtype=theta_dtype,
                wire_kind=wire)
    if kick:
        kick_w = rng.uniform(0.1, 2.0, size=(deg, j)).astype(np.float32)
        kick_w *= 1.0 - bar_w
        kick_w[0, :] = 0.0
        kick_w[:, j - 1] = 0.0
        case["kick_w"] = kick_w
    return case


def masked_torch_args(case, device="cpu"):
    """(positional args, gate keywords) of ``ops.consensus_round`` for a
    ``masked_round_case``, on ``device``."""
    args = torch_args(case)
    if case["theta_dtype"] == "bfloat16":
        args[0] = args[0].to(torch.bfloat16)
        if case["wire_kind"] == "native":
            args[3] = args[3].to(torch.bfloat16)
    kw = {k: torch.from_numpy(case[k]) for k in ("bar_w", "inv_deg",
                                                 "kick_w") if k in case}
    return ([a.to(device) for a in args],
            {k: v.to(device) for k, v in kw.items()})


def run_reference(module: str, tmp_path_factory,
                  fn: str = "_reference_outputs", arg: str | None = None
                  ) -> dict:
    """``<module>.<fn>()`` (``_reference_outputs`` by default), or
    ``<module>.<fn>(arg)``, run in a fresh Python process, as a dict of
    numpy arrays.

    The reference runs on the CPU with a clean ``XLA_FLAGS`` (one device,
    unless ``fn`` sets a device count before it imports JAX), whatever
    flags the test process carries: a JAX backend started in the test
    process would lock in the flags that other test modules may have set
    at collection. Under pytest-xdist the workers of one run share the
    result: the first to ask computes it under a file lock, the others
    read it.
    """
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the run's, shared by workers
    call = f"{fn}()" if arg is None else f"{fn}({arg!r})"
    path = os.path.join(str(base), f"{module}.{fn}"
                        + ("" if arg is None else f".{arg}") + ".npz")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.npz"
            code = (f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]\n"
                    f"import numpy as np\nimport {module} as m\n"
                    f"np.savez({tmp!r}, **m.{call})\n")
            env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            proc = subprocess.run([sys.executable, "-c", code], env=env,
                                  capture_output=True, text=True,
                                  timeout=900)
            assert proc.returncode == 0, proc.stderr[-3000:]
            os.replace(tmp, path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_script(name: str, script: str, argv, tmp_path_factory,
               timeout: float = 900) -> str:
    """Run a reference ``script`` (``python -c``, with the npz path it
    writes as ``sys.argv[1]`` and then ``argv``) once per test run; returns
    that path. The xdist workers and the test modules that ask for the
    same ``name`` share the one result under a file lock, as
    ``run_reference`` does."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the run's, shared by workers
    path = os.path.join(str(base), f"script.{name}.npz")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.npz"
            env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
            proc = subprocess.run([sys.executable, "-c", script, tmp]
                                  + [str(a) for a in argv], env=env,
                                  capture_output=True, text=True,
                                  timeout=timeout)
            assert proc.returncode == 0, proc.stderr[-3000:]
            os.replace(tmp, path)
    return path
