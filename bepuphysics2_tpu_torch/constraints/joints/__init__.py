"""Joint registry: the 30 constraint type names of the reference (DefaultTypes.cs:18-49).

Counterpart of ``bepuphysics2_tpu/constraints/joints/__init__.py``. ``JOINT_TYPES`` names
every type; the port carries ``ball_socket`` and ``swing_limit`` (the ragdoll's joints),
and every other name maps to a stand-in that refuses to be banked, naming the ROADMAP
item that brings it.
"""
from types import SimpleNamespace

import numpy as np
import torch

from .angular import SwingLimit
from .base import JointBank, JointContext, MotorSettingsDesc, ServoSettingsDesc
from .linear import BallSocket

NOT_PORTED_ITEM = "ROADMAP queue 1 item 16 (the other joint types and multi-body joints)"


class _NotPortedJoint:
    """Stands in for a joint type of the JAX package that the port does not have yet."""

    def __init__(self, name: str, n_bodies: int = 2):
        self.name = name
        self.N_BODIES = n_bodies

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(f"joint type {self.name!r} is not ported yet: {NOT_PORTED_ITEM}")


_TWO_BODY_NAMES = [
    "ball_socket", "ball_socket_servo", "ball_socket_motor",
    "center_distance", "center_distance_limit", "distance_servo", "distance_limit",
    "angular_hinge", "angular_swivel_hinge", "swing_limit",
    "twist_servo", "twist_limit", "twist_motor",
    "angular_servo", "angular_motor", "angular_axis_motor", "angular_axis_gear_motor",
    "weld", "hinge", "swivel_hinge",
    "point_on_line_servo", "linear_axis_servo", "linear_axis_motor", "linear_axis_limit",
    "one_body_linear_servo", "one_body_linear_motor", "one_body_angular_servo",
    "one_body_angular_motor",
]
_MULTI_BODY = {"area": 3, "volume": 4}
PORTED_TYPES = {BallSocket.name: BallSocket, SwingLimit.name: SwingLimit}
JOINT_TYPES = {n: PORTED_TYPES.get(n) or _NotPortedJoint(n) for n in _TWO_BODY_NAMES}
JOINT_TYPES.update({n: _NotPortedJoint(n, k) for n, k in _MULTI_BODY.items()})

ONE_BODY_NAMES = {
    "one_body_linear_servo", "one_body_linear_motor",
    "one_body_angular_servo", "one_body_angular_motor",
}

_DEFAULTS = dict(spring_frequency=30.0, spring_damping=1.0)


def make_description(name: str, **params) -> SimpleNamespace:
    """A joint description with the servo, motor and spring defaults filled in."""
    d = dict(_DEFAULTS)
    if "servo" not in params:
        d["servo"] = ServoSettingsDesc()
    if "motor" not in params:
        d["motor"] = MotorSettingsDesc()
    d.update(params)
    return SimpleNamespace(**d)


class JointTypeStore:
    """Host-side fixed-capacity storage for one joint type (numpy staging, and the device
    bank cached per device until the host copy changes)."""

    def __init__(self, joint_cls, capacity: int):
        if isinstance(joint_cls, _NotPortedJoint):
            raise NotImplementedError(
                f"joint type {joint_cls.name!r} is not ported yet: {NOT_PORTED_ITEM}")
        self.cls = joint_cls
        self.capacity = capacity
        self.n_bodies = getattr(joint_cls, "N_BODIES", 2)
        self.bodies = np.zeros((capacity, max(self.n_bodies, 2)), np.int32)
        self.valid = np.zeros(capacity, bool)
        self.prestep = np.zeros((capacity, joint_cls.N_PRESTEP), np.float32)
        self.impulse = np.zeros((capacity, joint_cls.N_IMPULSE), np.float32)
        # Persisted solver color (-1 = unassigned); rides in SimState.joint_colors.
        self.color = np.full(capacity, -1, np.int32)
        self._free = list(range(capacity - 1, -1, -1))
        self._device = {}

    def grow(self, new_capacity: int) -> None:
        """Bank growth (reference Solver.EnsureTypeBatchCapacities): existing slots keep
        their indices; new slots join the free list."""
        old = self.capacity
        if new_capacity <= old:
            return
        extra = new_capacity - old
        self.bodies = np.concatenate([self.bodies, np.zeros((extra, self.bodies.shape[1]), np.int32)])
        self.valid = np.concatenate([self.valid, np.zeros(extra, bool)])
        self.prestep = np.concatenate([self.prestep, np.zeros((extra, self.cls.N_PRESTEP), np.float32)])
        self.impulse = np.concatenate([self.impulse, np.zeros((extra, self.cls.N_IMPULSE), np.float32)])
        self.color = np.concatenate([self.color, np.full(extra, -1, np.int32)])
        self._free = list(range(new_capacity - 1, old - 1, -1)) + self._free
        self.capacity = new_capacity
        self._device = {}

    def add(self, bodies, desc) -> int:
        if not self._free:
            self.grow(max(2 * self.capacity, 8))
        i = self._free.pop()
        bodies = list(np.atleast_1d(bodies))
        if len(bodies) == 1:
            bodies = bodies * 2  # one-body types: b == a
        self.bodies[i, :len(bodies)] = bodies
        self.valid[i] = True
        self.prestep[i] = self.cls.pack(desc)
        self.impulse[i] = 0.0
        self.color[i] = -1
        self._device = {}
        return i

    def remove(self, idx: int) -> None:
        self.valid[idx] = False
        self.color[idx] = -1
        self._free.append(idx)
        self._device = {}

    def update_description(self, idx: int, desc) -> None:
        self.prestep[idx] = self.cls.pack(desc)
        self._device = {}

    @property
    def count(self) -> int:
        return self.capacity - len(self._free)

    def device(self, device) -> dict:
        """The bank as tensors on ``device``: bodies, valid, prestep, impulse."""
        key = str(torch.device(device))
        if key not in self._device:
            t = lambda a: torch.from_numpy(np.array(a)).to(device)
            self._device[key] = dict(bodies=t(self.bodies), valid=t(self.valid),
                                     prestep=t(self.prestep), impulse=t(self.impulse))
        return self._device[key]

    def load_impulses(self, impulses) -> None:
        self.impulse = impulses.detach().cpu().numpy().copy()  # host copy stays writable
        for bank in self._device.values():
            bank["impulse"] = impulses.to(bank["prestep"].device)

    def load_colors(self, colors) -> None:
        self.color = colors.detach().cpu().numpy().copy()


__all__ = [
    "JOINT_TYPES", "PORTED_TYPES", "ONE_BODY_NAMES", "NOT_PORTED_ITEM", "JointBank",
    "JointContext", "JointTypeStore", "ServoSettingsDesc", "MotorSettingsDesc",
    "make_description",
]
