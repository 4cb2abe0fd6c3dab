"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro/checkpoint/checkpoint.py``, and the launcher's
``--ckpt-dir``/``--ckpt-every``.

(a) The format, as ``tests/test_substrate.py`` holds the reference's: a
    round trip with metadata, keep-k and the newest steps, a wrong
    structure refused, the async save, a half-written ``tmp.<step>``
    ignored, and every leaf dtype the state holds (float32, bfloat16,
    float8 e4m3fn and e5m2, int32, bool) restored bit for bit. The
    manifest's bytes equal ``msgpack.packb``'s (the port writes its own).
(b) Across the packages, in one reference process (``_reference_io``):
    the reference's ``restore`` reads a tree the port saved, and the
    port's ``restore`` reads one the reference saved, each bit for bit.
(c) Resume through the launcher: a synchronous run resumed from step k
    equals the uninterrupted run bit for bit (every leaf of the final
    checkpoint and its manifest), static and dynamic with a node dropped
    before k; an async run resumes its state (its round clock is host
    state that neither package checkpoints); a checkpoint of another grid
    is refused with both grids named. On gloo ranks the same for blocks of
    node rows, slabs and replicated in-pod shards
    (``torch_inpod_cases.RESUME_CASES``, run in the 4-rank spawn of
    ``tests/test_torch_inpod.py``).
"""
import os
import random
from typing import NamedTuple

import numpy as np
import pytest
import torch

import torch_inpod_cases as cases
from repro_torch import checkpoint as ck
from repro_torch.checkpoint.pack import packb, unpackb
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_round_cases import run_reference

DTYPES = ("float32", "bfloat16", "float8_e4m3fn", "float8_e5m2", "int32",
          "bool")


def seeded_tree() -> dict:
    """One leaf of each dtype, from numpy seed 0, as raw bits: ``{dtype:
    (the values' bytes as an unsigned or plain array, shape)}``."""
    rng = np.random.default_rng(0)
    out = {}
    for n, name in enumerate(DTYPES):
        shape = (3, 4 + n)
        if name == "int32":
            a = rng.integers(-1000, 1000, shape).astype(np.int32)
        elif name == "bool":
            a = rng.random(shape) > 0.5
        elif name == "float32":
            a = rng.standard_normal(shape).astype(np.float32)
        elif name == "bfloat16":
            a = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).bfloat16().view(torch.uint16).numpy()
        else:
            a = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(getattr(torch, name)).view(
                torch.uint8).numpy()
        out[name] = a
    return out


def torch_tree(bits: dict) -> dict:
    """``seeded_tree``'s bits as torch tensors of their dtypes."""
    out = {}
    for name, a in bits.items():
        t = torch.from_numpy(a.copy())
        if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
            t = t.view(getattr(torch, name))
        out[name] = t
    return out


def raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as the array ``seeded_tree`` holds them."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _reference_io() -> dict:
    """In the reference's process, in a temporary directory: the port
    saves ``seeded_tree``, the reference restores it (its bits returned
    under ``from_port/<dtype>``), and the reference saves the same tree at
    step 7, whose files come back as bytes (``ref_file/<name>``) for the
    test process to restore."""
    import tempfile

    import jax.numpy as jnp
    import ml_dtypes

    from repro.checkpoint import checkpoint as rck
    bits = seeded_tree()
    like, tree = {}, {}
    for name, a in bits.items():
        dt = getattr(ml_dtypes, name, None) or np.dtype(name)
        like[name] = jnp.zeros(a.shape, dt)
        tree[name] = jnp.asarray(a.view(dt) if a.dtype != dt else a)
    with tempfile.TemporaryDirectory() as base:
        ck.save(os.path.join(base, "port"), 3, torch_tree(bits),
                metadata={"step": 3, "who": "port"})
        got, meta = rck.restore(os.path.join(base, "port"), like)
        out = {f"from_port/{k}": np.asarray(v).view(bits[k].dtype)
               for k, v in got.items()}
        out["meta_who"] = np.asarray(meta["who"])
        out["dtypes"] = np.asarray([str(got[k].dtype) for k in DTYPES])
        step = rck.save(os.path.join(base, "ref"), 7, tree,
                        metadata={"step": 7, "who": "reference"})
        for name in os.listdir(step):
            with open(os.path.join(step, name), "rb") as f:
                out[f"ref_file/{name}"] = np.frombuffer(f.read(), np.uint8)
    return out


@pytest.fixture(scope="module")
def ref_io(tmp_path_factory):
    return run_reference("test_torch_checkpoint", tmp_path_factory,
                         fn="_reference_io")


# ----------------------------------------------------------- (a) format ----
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    ck.save(str(tmp_path), 10, tree, metadata={"step": 10, "note": "x"})
    restored, meta = ck.restore(str(tmp_path), tree)
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert meta["step"] == 10 and meta["note"] == "x"
    assert sorted(os.listdir(tmp_path / "step_0000000010")) == [
        "leaves.npz", "manifest.msgpack"]


def test_checkpoint_keep_k_and_latest(tmp_path):
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, tree, keep=2)
    assert ck.latest_steps(str(tmp_path)) == [3, 4]


def test_checkpoint_rejects_wrong_structure(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), {"a": torch.zeros(4)})


def test_checkpoint_async(tmp_path):
    """The host copy is taken at the call: writes to the tensor after it
    (the trainer updates in place) do not reach the checkpoint."""
    w = torch.full((8,), 3.0)
    tree = {"w": w}
    ck.save_async(str(tmp_path), 5, tree, metadata={"step": 5})
    w.fill_(-1.0)
    ck.wait_pending()
    restored, meta = ck.restore(str(tmp_path), tree)
    assert torch.equal(restored["w"], torch.full((8,), 3.0))
    assert meta["step"] == 5


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    """A crash mid-write (a tmp dir left behind) must not corrupt
    restore."""
    tree = {"w": torch.zeros(3)}
    ck.save(str(tmp_path), 1, tree)
    os.makedirs(str(tmp_path / "tmp.2"))
    (tmp_path / "tmp.2" / "junk").write_text("partial")
    os.makedirs(str(tmp_path / "step_0000000003"))    # never finished
    assert ck.latest_steps(str(tmp_path)) == [1]
    ck.restore(str(tmp_path), tree)


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoint_dtype_roundtrip(tmp_path, dtype):
    """Each leaf dtype of the state survives the npz bit for bit, under
    the reference's dtype name (bfloat16 and float8 as unsigned views)."""
    bits = seeded_tree()
    tree = torch_tree(bits)
    ck.save(str(tmp_path), 2, tree, metadata={"step": 2})
    restored, _ = ck.restore(str(tmp_path), tree)
    assert restored[dtype].dtype == tree[dtype].dtype
    assert np.array_equal(raw(restored[dtype]), bits[dtype])
    man = ck.read_manifest(str(tmp_path))
    assert man["dtypes"][sorted(DTYPES).index(dtype)] == dtype


class _State(NamedTuple):
    rows: torch.Tensor
    seed: int
    extra: object = None


def test_checkpoint_host_fields_and_order(tmp_path):
    """NamedTuple fields in order, dict keys sorted, None dropped; a field
    that is not a tensor goes into the metadata and comes back."""
    tree = {"z": _State(rows=torch.ones(2), seed=7),
            "a": [torch.zeros(1), None, torch.full((3,), 2.0)]}
    ck.save(str(tmp_path), 1, tree)
    man = ck.read_manifest(str(tmp_path))
    assert man["num_leaves"] == 3
    assert man["shapes"] == [[1], [3], [2]]
    assert man["metadata"]["host"] == {"z/seed": 7}
    like = {"z": _State(rows=torch.zeros(2), seed=0),
            "a": [torch.ones(1), None, torch.ones(3)]}
    got, _ = ck.restore(str(tmp_path), like)
    assert got["z"].seed == 7 and got["a"][1] is None
    assert torch.equal(got["a"][2], tree["a"][2])


def _values(rng: random.Random, depth: int = 0):
    kind = rng.randrange(8 if depth < 3 else 5)
    if kind == 0:
        return rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                           2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128,
                           -129, -32768, -32769, -2**31, -2**31 - 1,
                           -2**63])
    if kind == 1:
        return rng.uniform(-1e10, 1e10)
    if kind == 2:                # str 32 (past 65535 bytes) at the top
        return "".join(chr(rng.randrange(32, 0x3000)) for _ in range(
            rng.choice([0, 5, 31, 32, 255, 256]
                       + ([70000] if depth == 0 else []))))
    if kind == 3:
        return rng.choice([None, True, False])
    if kind == 4:
        return rng.choice([1.5, float("inf"), -0.0])
    # a long array or map (the 16-bit forms) holds scalars only
    if kind == 5:
        n = rng.choice([0, 3, 15, 16, 300])
        return [_values(rng, depth + 1 if n <= 16 else 3) for _ in range(n)]
    if kind == 6:
        n = rng.choice([0, 3, 15, 16, 40])
        return {f"k{i}": _values(rng, depth + 1 if n <= 16 else 3)
                for i in range(n)}
    return tuple(_values(rng, depth + 1) for _ in range(3))


def test_manifest_bytes_equal_msgpack(tmp_path):
    """The port's writer gives ``msgpack.packb``'s bytes for every form
    the manifest's types take (each length and integer width), and its
    reader reads them back; a manifest on disk is those bytes."""
    import msgpack
    rng = random.Random(0)
    for _ in range(300):
        obj = _values(rng)
        want = msgpack.packb(obj)
        assert packb(obj) == want, obj
        assert unpackb(want) == msgpack.unpackb(want)
    ck.save(str(tmp_path), 4, torch_tree(seeded_tree()),
            metadata={"step": 4, "grid": {"nodes": 2, "mesh": None}})
    with open(tmp_path / "step_0000000004" / "manifest.msgpack", "rb") as f:
        data = f.read()
    assert msgpack.packb(msgpack.unpackb(data)) == data
    assert unpackb(data) == msgpack.unpackb(data)


# ------------------------------------------------ (b) across the packages ----
def test_reference_restores_port_checkpoint(ref_io):
    """The reference's ``restore`` reads the port's checkpoint: every
    dtype bit for bit, in its own dtype."""
    bits = seeded_tree()
    assert str(ref_io["meta_who"]) == "port"
    assert list(ref_io["dtypes"]) == list(DTYPES)
    for name in DTYPES:
        assert np.array_equal(ref_io[f"from_port/{name}"], bits[name]), name


def test_port_restores_reference_checkpoint(ref_io, tmp_path):
    """The port's ``restore`` reads the reference's checkpoint: every
    dtype bit for bit, in its own dtype."""
    step = tmp_path / "step_0000000007"
    step.mkdir()
    names = [k[len("ref_file/"):] for k in ref_io if k.startswith("ref_file/")]
    assert sorted(names) == ["leaves.npz", "manifest.msgpack"]
    for name in names:
        (step / name).write_bytes(ref_io[f"ref_file/{name}"].tobytes())
    bits = seeded_tree()
    like = {k: torch.zeros_like(v) for k, v in torch_tree(bits).items()}
    got, meta = ck.restore(str(tmp_path), like)
    assert meta == {"step": 7, "who": "reference"}
    for name in DTYPES:
        assert got[name].dtype == like[name].dtype
        assert np.array_equal(raw(got[name]), bits[name]), name


# --------------------------------------------------------- (c) resume ----
LAUNCH = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
          "--local-steps", "2", "--ckpt-every", "2"]
RESUMES = {
    "static": (["--nodes", "2"], 4, 2),
    "dynamic": (["--nodes", "4", "--topology", "complete",
                 "--topo-scheduler", "round_robin", "--drop-node", "1:1"],
                6, 4),
}


def _launch(argv):
    from repro_torch.launch.train import main
    assert main(LAUNCH + argv) == 0


@pytest.mark.parametrize("kind", list(RESUMES))
def test_resume_equals_uninterrupted(tmp_path, capsys, kind):
    """A run stopped at step k with its checkpoint and started again on
    the same directory equals the uninterrupted run bit for bit: the
    final checkpoints are the same bytes, and the losses after k too
    (dynamic: the budget scheduler on J 4 with node 1 dropped after step
    1, before k)."""
    extra, steps, k = RESUMES[kind]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _launch(extra + ["--steps", str(steps), "--ckpt-dir", full])
    out_full = capsys.readouterr().out
    _launch(extra + ["--steps", str(k), "--ckpt-dir", part])
    capsys.readouterr()
    _launch(extra + ["--steps", str(steps), "--ckpt-dir", part])
    out_part = capsys.readouterr().out
    assert f"resumed from step {k}" in out_part
    tail = lambda text: [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                         if ln.startswith("step") and int(ln.split()[1]) >= k]
    assert tail(out_part) == tail(out_full) and tail(out_full)
    if kind == "dynamic":
        assert "dropped node 1" in out_full
    cases.same_checkpoint(os.path.join(full, f"step_{steps:010d}"),
                    os.path.join(part, f"step_{steps:010d}"))


def test_async_resume_restores_state(tmp_path, capsys):
    """An async run resumed from step 2 starts from the checkpoint's
    state: its first local step's loss equals the uninterrupted run's. Its
    round clock starts afresh (host state that neither package
    checkpoints), so the rounds after are not held to the uninterrupted
    run's."""
    extra = ["--nodes", "3", "--async", "--max-staleness", "1",
             "--slow-node", "0:3.0"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _launch(extra + ["--steps", "4", "--ckpt-dir", full])
    out_full = capsys.readouterr().out
    _launch(extra + ["--steps", "2", "--ckpt-dir", part])
    capsys.readouterr()
    _launch(extra + ["--steps", "4", "--ckpt-dir", part])
    out_part = capsys.readouterr().out
    first = lambda text: next(ln.split("|")[0].rsplit(" ", 1)[0].strip()
                              for ln in text.splitlines()
                              if ln.startswith("step     2"))
    assert "resumed from step 2" in out_part
    assert first(out_part) == first(out_full)


def test_grid_mismatch_refused(tmp_path, capsys):
    """A checkpoint names its grid: a run on another grid (an in-pod mesh
    instead of none, another wire codec) refuses it, naming both."""
    d = str(tmp_path / "ck")
    _launch(["--nodes", "2", "--steps", "2", "--ckpt-dir", d])
    for other in (["--mesh", "debug"], ["--wire-codec", "int8"]):
        with pytest.raises(ValueError, match="written on the grid") as e:
            _launch(["--nodes", "2", "--steps", "4", "--ckpt-dir", d]
                    + other)
        assert "'ranks': 1" in str(e.value) and str(e.value).count(
            "'codec'") == 2


# ------------------------------------------------------ (c) on ranks ----
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.spawned_ranks(tmp_path_factory)


@pytest.mark.parametrize("name", list(cases.RESUME_CASES))
def test_resume_on_ranks_equals_uninterrupted(ranks, name):
    """On 4 gloo ranks, through the launcher: blocks of node rows (J 8, 2
    a rank), slabs (J 2 x S 2, ``--shard-consensus``) and replicated
    in-pod shards (J 2, data 1 x model 2 a node): the run resumed from
    step 2 ends in the same checkpoint bytes as the uninterrupted run,
    every rank's file and the manifest, with the same losses and round
    metrics after step 2."""
    d, outs = ranks
    base = os.path.join(d, f"resume_{name}")
    step = f"step_{cases.RESUME_STEPS:010d}"
    cases.same_checkpoint(os.path.join(base, "full", step),
                    os.path.join(base, "resumed", step))
    files = os.listdir(os.path.join(base, "full", step))
    assert sum(f.startswith("leaves.rank") for f in files) == 4
    for r in outs:
        got = r["resume"][name]
        assert got["start_step"] == cases.RESUME_AT
        full, resumed = got["full"], got["resumed"]
        assert resumed["losses"] == full["losses"][cases.RESUME_AT:]
        assert resumed["rounds"] == full["rounds"][-len(resumed["rounds"]):]


def test_ranks_checkpoint_refused_by_one_process(ranks, capsys):
    """The replicated in-pod ranks' checkpoint (R 4) is refused by one
    process computing the same grid whole (R 1)."""
    from repro_torch.distributed import trivial_grid
    from repro_torch.launch import train
    d, _ = ranks
    src = os.path.join(d, "resume_inpod", "full")
    args = cases.resume_args("inpod", src)
    with pytest.raises(ValueError, match="written on the grid"):
        train.run(cases.cfg(cases.PATH_ARCH), args,
                  trivial_grid(2, "cpu", mesh=cases.RANKS_CONS_MESH))
