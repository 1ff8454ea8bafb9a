"""chip_smoke.py's KinkReplay: the plain training step takes the kernel
step's side of every ReLU kink, so that an input that rounds to the other
side of 0 does not turn a rounding difference into a whole gradient term."""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    # looked up at call time, as the models do
    return torch.relu(x) if kind == "relu" else F.leaky_relu(x, 0.2)


def _step(replay, kind: str, x0: torch.Tensor, as_plain: bool):
    x = x0.clone().requires_grad_(True)
    with replay.patched(replay=as_plain):
        y = _act(kind, x * 3.0)
    (g,) = torch.autograd.grad((y * torch.arange(1.0, 7.0)).sum(), x)
    return y.detach(), g


@pytest.mark.parametrize("kind", ["relu", "leaky_relu"])
def test_the_plain_step_takes_the_kernel_steps_side(smoke, kind):
    kernel_x = torch.tensor([1.0, -2.0, 1e-9, -1e-9, 0.5, -0.5])
    plain_x = torch.tensor([1.0, -2.0, -1e-9, 1e-9, 0.5, -0.5])
    replay = smoke.KinkReplay()
    yk, gk = _step(replay, kind, kernel_x, as_plain=False)
    yp, gp = _step(replay, kind, plain_x, as_plain=True)
    assert replay.ties == 2
    assert torch.equal(gk, gp)
    torch.testing.assert_close(yk, yp, rtol=0.0, atol=1e-8)
    # without the replay the two gradients differ by whole terms
    free = smoke.KinkReplay()
    _, g_free = _step(free, kind, plain_x, as_plain=False)
    assert not torch.equal(gk, g_free)


@pytest.mark.parametrize("kind", ["relu", "leaky_relu"])
def test_recording_leaves_the_values_and_gradients_as_they_were(smoke, kind):
    x0 = torch.linspace(-2.0, 2.0, 6)
    y, g = _step(smoke.KinkReplay(), kind, x0, as_plain=False)
    x = x0.clone().requires_grad_(True)
    want = _act(kind, x * 3.0)
    (g_want,) = torch.autograd.grad((want * torch.arange(1.0, 7.0)).sum(), x)
    assert torch.equal(y, want.detach()) and torch.equal(g, g_want)
    assert torch.relu is not None and F.leaky_relu(torch.tensor(-1.0), 0.5) == -0.5


def test_a_side_beyond_rounding_is_refused(smoke):
    replay = smoke.KinkReplay()
    _step(replay, "relu", torch.tensor([1.0, 0.5, 0.0, 0.0, 0.0, 0.0]), False)
    with pytest.raises(AssertionError, match="another side"):
        _step(replay, "relu", torch.tensor([1.0, -0.5, 0.0, 0.0, 0.0, 0.0]),
              True)
    assert torch.relu(torch.tensor(-1.0)) == 0.0       # restored on error


def test_the_two_steps_must_call_the_same_relus(smoke):
    replay = smoke.KinkReplay()
    with replay.patched(replay=False):
        torch.relu(torch.ones(3))
        torch.relu(torch.ones(3))
    with pytest.raises(AssertionError, match="fewer ReLUs"):
        with replay.patched(replay=True):
            torch.relu(torch.ones(3))
    with pytest.raises(AssertionError, match="shapes differ"):
        with replay.patched(replay=True):
            torch.relu(torch.ones(4))
