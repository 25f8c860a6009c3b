"""One scene of the trajectory-parity envelope of ``parity/run_parity.py`` through the
PyTorch port on the CPU (``tools/parity_port.py``), within that harness's own thresholds
over its steps: the sphere dropped 2 m onto a static box: its ballistic flight against
the closed form, its settling and rest against the scalar TGS reference of
``parity/run_parity.py``.

Each scene of the envelope is a file of its own, so that the test workers run the scenes
side by side."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import parity_port  # noqa: E402


@pytest.mark.parametrize("scene", ["sphere_drop"])
def test_port_holds_the_parity_envelope(scene):
    env = parity_port.run(scene)
    assert env["pass"], env
