"""Package rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
  reference package ``repro``, nor ``msgpack`` or ``ml_dtypes``, which the
  port does not depend on (an AST walk over every import).
* ``repro_torch`` imports on a machine without CUDA, and importing it
  loads none of those; importing any of the port's test modules loads
  neither JAX nor the reference (they compute the reference in a fresh
  process):
  one interpreter imports them in turn, with ``sys.modules`` read after
  each.
* Nothing falls back: a tensor off the CPU never reaches the plain version,
  CUDA asked for without a card is an error, and ``chip_smoke.py`` fails
  without a card or without the repository beside it.
"""
import ast
import fcntl
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels import build, consensus_update, ops

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_without_cuda_or_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'msgpack', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# imports the modules named on its command line in turn, printing after
# each one line of JSON: the module, the JAX or reference modules loaded so
# far, and an import error; stops after the first module that loads JAX or
# the reference, or fails to import, so that a fresh interpreter takes the
# next one and no module is judged on another's imports
_IMPORT_SCRIPT = """
import json, sys, traceback
for name in sys.argv[1:]:
    try:
        __import__(name)
        err = None
    except BaseException:
        err = traceback.format_exc()[-3000:]
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({"module": name, "bad": bad, "error": err}),
          flush=True)
    if bad or err:
        break
"""


def _import_records(tmp_path_factory) -> dict:
    """What importing each port test module loads, recorded once per test
    run (the xdist workers share it under a file lock, as
    ``torch_round_cases.run_reference`` shares the reference's outputs):
    the modules go through one interpreter in turn, and after one that
    loads JAX or the reference (or fails) a fresh interpreter continues."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the run's, shared by workers
    path = base / "port_test_imports.json"
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
            env.pop("PYTHONPATH", None)
            records = {}
            left = [p.stem for p in PORT_TESTS]
            while left:
                proc = subprocess.run(
                    [sys.executable, "-c",
                     f"import sys; sys.path[:0] = [{str(ROOT / 'tests')!r},"
                     f" {str(ROOT / 'src')!r}]\n" + _IMPORT_SCRIPT] + left,
                    env=env, capture_output=True, text=True, timeout=600)
                got = [json.loads(ln) for ln in proc.stdout.splitlines()
                       if ln.startswith("{")]
                if not got:                 # the interpreter itself failed
                    records[left[0]] = {"bad": [], "error": proc.stderr}
                    got = [{"module": left[0]}]
                records.update({r["module"]: r for r in got
                                if r["module"] not in records})
                left = left[len(got):]
            path.write_text(json.dumps(records))
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def import_records(tmp_path_factory):
    return _import_records(tmp_path_factory)


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_test_module_starts_no_jax(path, import_records):
    """Importing a port test module loads neither JAX nor the reference, so
    no JAX backend starts in the test process."""
    rec = import_records[path.stem]
    assert rec["error"] is None, rec["error"]
    assert not rec["bad"], rec["bad"]


def test_no_fallback_off_the_cpu():
    x = torch.zeros(2, 128, device="meta")
    w = torch.zeros(1, 2, 128, device="meta")
    v = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.consensus_round(x, x, x, w, torch.ones(1, 2, 1), v[None], v, v,
                            v, block_leaf=[0], block_size=128)
    # the launch path refuses a CPU tensor instead of computing anything
    c = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="not on a CUDA card"):
        consensus_update.launch(c, c, c, c[None], torch.ones(1, 2, 1),
                                torch.ones(1, 2), torch.ones(2),
                                torch.ones(2), torch.ones(2),
                                torch.zeros(1, dtype=torch.int32), 128)


def test_cuda_without_a_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--steps", "1"])       # --device defaults to cuda


def test_missing_nvcc_is_an_error(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, {})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
