"""The port's example entry points (``python -m repro_torch.examples.*``):
without ``--device cpu`` they ask for the card and raise on a machine
without one (nothing falls back to the CPU); with it they print their
reference example's table, here at a small iteration budget."""
import pytest
import torch

from repro_torch.examples import dppca_sfm, dynamic_topology, quickstart
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

TINY = {
    "quickstart": (quickstart, ["--max-iters", "2"]),
    "dynamic_topology": (dynamic_topology, ["--shed-epochs", "20",
                                            "--churn-epochs", "2"]),
    "dppca_sfm": (dppca_sfm, ["--max-iters", "10"]),
}


@pytest.mark.parametrize("name", list(TINY))
def test_example_needs_the_card_by_default(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = TINY[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


@pytest.mark.parametrize("name", list(TINY))
def test_example_runs_on_the_cpu(capsys, name):
    module, argv = TINY[name]
    module.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    if name == "quickstart":
        assert out[0].split() == ["scheme", "topology", "iters", "max|w-w*|",
                                  "consensus"]
        assert len(out) == 13 and all(ln.split()[2] == "2" for ln in out[1:])
    elif name == "dynamic_topology":
        assert out[0].startswith("converged in ")
        assert out[1].startswith("  + 20 epochs: active edges ")
        assert out[2].startswith("dropped node 7: 11/12 alive")
    else:
        assert out[0].startswith("scene: 90 points, 30 frames, 5 cameras")
        assert len(out) == 5 and all(" 10 iters, structure angle" in ln
                                     for ln in out[1:])
