"""Joint registry: all 30 constraint types of the reference (DefaultTypes.cs:18-49).

Counterpart of ``bepuphysics2_tpu/constraints/joints/__init__.py``: the same names,
classes, bank layouts and host-side store.
"""
from types import SimpleNamespace

import numpy as np
import torch

from .angular import (
    AngularAxisGearMotor,
    AngularAxisMotor,
    AngularHinge,
    AngularMotor,
    AngularServo,
    AngularSwivelHinge,
    SwingLimit,
    TwistLimit,
    TwistMotor,
    TwistServo,
)
from .base import JointBank, JointContext, MotorSettingsDesc, ServoSettingsDesc
from .combo import Hinge, SwivelHinge, Weld
from .linear import (
    BallSocket,
    BallSocketMotor,
    BallSocketServo,
    CenterDistance,
    CenterDistanceLimit,
    DistanceLimit,
    DistanceServo,
)
from .linear_axis import LinearAxisLimit, LinearAxisMotor, LinearAxisServo, PointOnLineServo
from .multibody import AreaConstraint, MultiBodyContext, VolumeConstraint
from .onebody import (
    OneBodyAngularMotor,
    OneBodyAngularServo,
    OneBodyLinearMotor,
    OneBodyLinearServo,
)

TWO_BODY_TYPES = [
    BallSocket, BallSocketServo, BallSocketMotor,
    CenterDistance, CenterDistanceLimit, DistanceServo, DistanceLimit,
    AngularHinge, AngularSwivelHinge, SwingLimit,
    TwistServo, TwistLimit, TwistMotor,
    AngularServo, AngularMotor, AngularAxisMotor, AngularAxisGearMotor,
    Weld, Hinge, SwivelHinge,
    PointOnLineServo, LinearAxisServo, LinearAxisMotor, LinearAxisLimit,
    OneBodyLinearServo, OneBodyLinearMotor, OneBodyAngularServo, OneBodyAngularMotor,
]
MULTI_BODY_TYPES = [AreaConstraint, VolumeConstraint]
ALL_TYPES = TWO_BODY_TYPES + MULTI_BODY_TYPES
JOINT_TYPES = {t.name: t for t in ALL_TYPES}

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
    "JOINT_TYPES", "ALL_TYPES", "TWO_BODY_TYPES", "MULTI_BODY_TYPES", "ONE_BODY_NAMES",
    "JointBank", "JointContext", "MultiBodyContext", "JointTypeStore", "ServoSettingsDesc",
    "MotorSettingsDesc", "make_description",
]
