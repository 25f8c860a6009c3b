"""The trajectory-parity envelope of ``parity/run_parity.py`` through the PyTorch port on
the CPU (``tools/parity_port.py``): the dropped sphere's ballistic flight against the
closed form and its settling and rest against the scalar TGS reference, the sliding and
spinning sphere, the ball-socket pendulum and the two stacked boxes under a lateral
force, each against ``parity/oracles.py`` within ``run_parity.py``'s own thresholds over
its 1,000 steps (the box stack: 120 settling and 300 pushed steps at each of two forces),
and the 3-link hinge chain against its conservation envelopes (energy never grows, the
sockets and hinge axes stay put)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import parity_port  # noqa: E402


@pytest.mark.parametrize("scene", sorted(parity_port.SCENES))
def test_port_holds_the_parity_envelope(scene):
    env = parity_port.run(scene)
    assert env["pass"], env
