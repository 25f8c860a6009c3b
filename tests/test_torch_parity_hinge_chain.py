"""One scene of the trajectory-parity envelope of ``parity/run_parity.py`` through the
PyTorch port on the CPU (``tools/parity_port.py``), within that harness's own thresholds
over its steps: the 3-link hinge chain against its conservation envelopes (energy never
grows, the sockets and hinge axes stay put).

Each scene of the envelope is a file of its own, so that the test workers run the scenes
side by side."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import parity_port  # noqa: E402


@pytest.mark.parametrize("scene", ["hinge_chain"])
def test_port_holds_the_parity_envelope(scene):
    env = parity_port.run(scene)
    assert env["pass"], env
