"""The 30-type joint battery of ``tests/test_joint_behavior.py`` through the port alone, on
the CPU (``models.joint_rigs``, the reference ConstraintTestDemo matrix): after 150 steps
of one zero-gravity scene every rig has converged, servos to their targets, motors to
their velocities, limits into their asymmetric ranges, geometric constraints to their
invariants."""
import pytest
import torch

from bepuphysics2_tpu_torch.constraints.joints import JOINT_TYPES
from bepuphysics2_tpu_torch.models.joint_rigs import ALL_NAMES, build_joint_rigs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rigged():
    return build_joint_rigs(device="cpu")


@pytest.mark.parametrize("name", ALL_NAMES)
def test_joint_behavior(rigged, name):
    fns = [fn for n, fn in rigged.checks if n == name]
    assert fns, f"no rig registered for {name}"
    for fn in fns:
        fn()


def test_all_30_types_covered(rigged):
    covered = {n for n, _ in rigged.checks}
    assert covered == set(ALL_NAMES) == set(JOINT_TYPES)
