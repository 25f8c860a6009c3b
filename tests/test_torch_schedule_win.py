"""Queue 1 item 11 on the windowed layout: ``tests/test_torch_schedule.py``'s pile (the
schedule (2, 1, 3) and the radial-gravity callback) with ``solver_backend="pallas_win"``
and the grid2 broad phase, whose store runs the substep loop through K4 (one launch per
iteration). One port step from each of the first ten frames of the JAX package's own run
(``backend="pallas_win"``, its K4 in interpret mode) against the JAX package's next
state, within 1e-5. A file of its own, so that the two JAX runs go to two workers."""
import pytest
import torch

from test_torch_schedule import FRAMES, carry_jax, check_step_from, port_config

WIN = dict(solver_backend="pallas_win", broadphase="grid2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_win():
    return carry_jax(**WIN)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_windowed_schedule_and_callback_step_matches_jax_pallas_win(jax_win, frame):
    check_step_from(jax_win, frame, port_config(**WIN))
