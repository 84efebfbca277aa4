"""The port's examples (``repro_torch.examples``), each ``main`` on the CPU
at its smallest arguments; on a machine without a card, without
``--device cpu`` they raise."""

import math

import numpy as np
import pytest
import torch

from repro_torch.examples import passrate_prediction, quickstart, serve_search, train_policy

torch.set_num_threads(2)

SMALLEST = {
    "quickstart": (quickstart, ["--simulations", "16", "--max-moves", "2"]),
    "passrate_prediction": (passrate_prediction, ["--levels", "1", "--games", "1"]),
    "train_policy": (train_policy, ["--steps", "4"]),
    "serve_search": (serve_search, ["--train-steps", "2", "--simulations", "8"]),
}


def test_quickstart(capsys):
    module, args = SMALLEST["quickstart"]
    out = module.main(args + ["--device", "cpu"])
    assert set(out["actions"]) == {"uct", "wu_uct"}
    assert all(0 <= a < 36 for a in out["actions"].values())
    assert 1 <= out["moves"] <= 2 and math.isfinite(out["return"])
    assert "episode return=" in capsys.readouterr().out


def test_passrate_prediction():
    module, args = SMALLEST["passrate_prediction"]
    out = module.main(args + ["--device", "cpu"])
    assert out["features"].shape == (1, 6)
    assert np.all((out["features"] >= 0) & (out["features"] <= 1.5))
    assert math.isfinite(out["mae_train"])


def test_train_policy_restores_and_reaches_the_last_step(capsys):
    module, args = SMALLEST["train_policy"]
    out = module.main(args + ["--device", "cpu"])
    assert (out["restored_at"], out["last_step"]) == (2, 4)
    assert len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"])
    assert "resumed training reached final step" in capsys.readouterr().out


def test_serve_search():
    module, args = SMALLEST["serve_search"]
    out = module.main(args + ["--device", "cpu"])
    assert len(out["outputs"]) == 6 and all(len(o) > 0 for o in out["outputs"])
    assert len(out["service_tokens"]) == 4
    assert all(0 <= t < 128 for t in out["service_tokens"])
    assert math.isfinite(out["greedy_reward"]) and math.isfinite(out["search_reward"])


@pytest.mark.parametrize("name", sorted(SMALLEST))
def test_examples_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    module, args = SMALLEST[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args)
