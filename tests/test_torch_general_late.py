"""The later frames of ``tests/test_torch_general.py``'s general-solve check (frames 5-9
and frame 60, when the ragdolls lie on the tube's panels): ``solve_all`` from each carried
JAX state against the JAX ``solve_all`` with ``backend="pallas"``, within 1e-5. A file of
its own, so that its JAX run goes to another test worker than the early frames'."""
import pytest
import torch

from test_torch_general import LATE, carry_jax_tube, check_general_solve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tube():
    return carry_jax_tube(LATE)


@pytest.mark.parametrize("frame", LATE)
def test_general_solve_matches_jax_pallas(jax_tube, frame):
    check_general_solve(jax_tube, frame)
