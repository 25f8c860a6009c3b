"""Body state: a fixed-capacity SoA NamedTuple of tensors + the host-side description API.

The counterpart of ``bepuphysics2_tpu/bodies.py``: ONE fixed-capacity struct of arrays for
every collidable (dynamic, kinematic and static alike) with per-body kind and mask fields.
Statics are body slots with zero inverse mass and inertia; sleeping is the ``awake``
mask. Topology mutation happens host-side (numpy) between steps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .utils.vec import Quat, Sym3, Vec3

KIND_EMPTY = 0
KIND_DYNAMIC = 1
KIND_KINEMATIC = 2
KIND_STATIC = 3


class BodyState(NamedTuple):
    """Device state of all bodies. Every leaf has leading dim = capacity NB."""

    pos: Vec3
    orn: Quat
    vel: Vec3
    omega: Vec3
    inv_mass: torch.Tensor  # (NB,) 0 for kinematic/static
    inv_inertia: Sym3  # local-frame inverse inertia tensor
    kind: torch.Tensor  # (NB,) int32 KIND_*
    awake: torch.Tensor  # (NB,) bool
    shape: torch.Tensor  # (NB,) int32 shape registry row, -1 = no collidable
    friction: torch.Tensor
    spring_frequency: torch.Tensor
    spring_damping: torch.Tensor
    max_recovery_velocity: torch.Tensor
    sleep_threshold: torch.Tensor
    sleep_timer: torch.Tensor
    sleep_island: torch.Tensor  # (NB,) int32
    collision_group: torch.Tensor  # (NB,) int32
    continuity: torch.Tensor  # (NB,) int32
    spec_margin_min: torch.Tensor
    spec_margin_max: torch.Tensor

    @property
    def exists(self):
        return self.kind != KIND_EMPTY

    @property
    def is_dynamic(self):
        return self.kind == KIND_DYNAMIC

    @property
    def integrable(self):
        """Awake dynamics and kinematics."""
        return ((self.kind == KIND_DYNAMIC) | (self.kind == KIND_KINEMATIC)) & self.awake

    def world_inv_inertia(self) -> Sym3:
        return self.inv_inertia.rotation_sandwich(self.orn.to_matrix())

    @staticmethod
    def empty(capacity: int, device="cuda") -> "BodyState":
        """``capacity`` empty slots on ``device``: at rest at the origin, no shape (-1),
        the default speculative margins (0.1 and 3e38)."""
        f32, i32 = torch.float32, torch.int32

        def z(dtype=f32):
            return torch.zeros(capacity, dtype=dtype, device=device)

        return BodyState(
            pos=Vec3.zeros(capacity, device=device), orn=Quat.identity(capacity, device=device),
            vel=Vec3.zeros(capacity, device=device), omega=Vec3.zeros(capacity, device=device),
            inv_mass=z(), inv_inertia=Sym3.zeros(capacity, device=device), kind=z(i32),
            awake=z(torch.bool), shape=torch.full((capacity,), -1, dtype=i32, device=device),
            friction=z(), spring_frequency=z(), spring_damping=z(), max_recovery_velocity=z(),
            sleep_threshold=z(), sleep_timer=z(), sleep_island=z(i32), collision_group=z(i32),
            continuity=z(i32),
            spec_margin_min=torch.full((capacity,), 0.1, dtype=f32, device=device),
            spec_margin_max=torch.full((capacity,), 3.0e38, dtype=f32, device=device))


@dataclasses.dataclass
class BodyDescription:
    """Mirror of reference BodyDescription (BepuPhysics/BodyDescription.cs)."""

    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    velocity: tuple = (0.0, 0.0, 0.0)
    angular_velocity: tuple = (0.0, 0.0, 0.0)
    inv_mass: float = 0.0
    inv_inertia: tuple = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)  # xx, yx, yy, zx, zy, zz
    shape: int = -1
    kind: int = KIND_DYNAMIC
    friction: float = 1.0
    spring_frequency: float = 30.0
    spring_damping: float = 1.0
    max_recovery_velocity: float = 2.0
    sleep_threshold: float = 0.01
    speculative_margin: float = 0.1
    speculative_margin_max: float = 3.0e38
    collision_group: int = 0
    continuity: int = 0

    @staticmethod
    def dynamic(position, shape, mass, shape_obj=None, **kw) -> "BodyDescription":
        """Inertia from the shape object when given (a full symmetric inverse where it
        gives one: hulls, triangles), else a unit-sphere-like diagonal."""
        if shape_obj is not None:
            res = shape_obj.compute_inertia(mass)
            if len(res) == 3:
                inv_mass, _, inv = res
                inv_inertia = (float(inv[0, 0]), float(inv[1, 0]), float(inv[1, 1]),
                               float(inv[2, 0]), float(inv[2, 1]), float(inv[2, 2]))
            else:
                inv_mass, diag = res
                inv_inertia = (diag[0], 0.0, diag[1], 0.0, 0.0, diag[2])
        else:
            inv_mass = 1.0 / mass
            inv_inertia = (inv_mass, 0.0, inv_mass, 0.0, 0.0, inv_mass)
        return BodyDescription(
            position=position, shape=shape, inv_mass=inv_mass, inv_inertia=inv_inertia,
            kind=KIND_DYNAMIC, **kw,
        )

    @staticmethod
    def kinematic(position, shape=-1, **kw) -> "BodyDescription":
        return BodyDescription(position=position, shape=shape, kind=KIND_KINEMATIC, **kw)


@dataclasses.dataclass
class StaticDescription:
    """Mirror of reference StaticDescription (BepuPhysics/Statics.cs:61)."""

    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    shape: int = -1
    friction: float = 1.0
    spring_frequency: float = 30.0
    spring_damping: float = 1.0
    max_recovery_velocity: float = 2.0
    collision_group: int = 0
    speculative_margin: float = 0.1
    speculative_margin_max: float = 3.0e38


def to_device(a, device) -> torch.Tensor:
    """A host array on ``device``. To a CUDA device through pinned memory and a copy that
    does not wait for the device (from pageable memory the copy is a host sync)."""
    x = torch.from_numpy(np.array(a))  # a copy: the host may write the array again
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


class BodyBuffer:
    """Host-side numpy staging for body state with handle (= slot) recycling
    (reference Bodies.Add/RemoveAt, Bodies.cs:183,267, minus compaction)."""

    FIELDS_F32 = [
        "px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz", "wx", "wy", "wz",
        "inv_mass", "ixx", "iyx", "iyy", "izx", "izy", "izz",
        "friction", "spring_frequency", "spring_damping", "max_recovery_velocity",
        "sleep_threshold", "sleep_timer", "spec_margin_min", "spec_margin_max",
    ]

    def __init__(self, capacity: int):
        self.capacity = capacity
        for f in self.FIELDS_F32:
            setattr(self, f, np.zeros(capacity, np.float32))
        self.qw[:] = 1.0
        self.spec_margin_min[:] = 0.1
        self.spec_margin_max[:] = 3.0e38
        self.kind = np.zeros(capacity, np.int32)
        self.awake = np.zeros(capacity, bool)
        self.shape = np.full(capacity, -1, np.int32)
        self.sleep_island = np.zeros(capacity, np.int32)
        self.collision_group = np.zeros(capacity, np.int32)
        self.continuity = np.zeros(capacity, np.int32)
        self._free = list(range(capacity - 1, -1, -1))

    def add(self, d) -> int:
        if not self._free:
            raise RuntimeError("body buffer full; raise capacity")
        i = self._free.pop()
        self.px[i], self.py[i], self.pz[i] = d.position
        self.qx[i], self.qy[i], self.qz[i], self.qw[i] = d.orientation
        if isinstance(d, StaticDescription):
            self.vx[i] = self.vy[i] = self.vz[i] = 0
            self.wx[i] = self.wy[i] = self.wz[i] = 0
            self.inv_mass[i] = 0
            self.ixx[i] = self.iyx[i] = self.iyy[i] = 0
            self.izx[i] = self.izy[i] = self.izz[i] = 0
            self.kind[i] = KIND_STATIC
            self.awake[i] = False
            self.sleep_threshold[i] = 0
        else:
            self.vx[i], self.vy[i], self.vz[i] = d.velocity
            self.wx[i], self.wy[i], self.wz[i] = d.angular_velocity
            self.inv_mass[i] = d.inv_mass if d.kind == KIND_DYNAMIC else 0.0
            ii = d.inv_inertia if d.kind == KIND_DYNAMIC else (0.0,) * 6
            self.ixx[i], self.iyx[i], self.iyy[i] = ii[0], ii[1], ii[2]
            self.izx[i], self.izy[i], self.izz[i] = ii[3], ii[4], ii[5]
            self.kind[i] = d.kind
            self.awake[i] = True
            self.sleep_threshold[i] = d.sleep_threshold
        self.shape[i] = d.shape
        self.friction[i] = d.friction
        self.spring_frequency[i] = d.spring_frequency
        self.spring_damping[i] = d.spring_damping
        self.max_recovery_velocity[i] = d.max_recovery_velocity
        self.collision_group[i] = getattr(d, "collision_group", 0)
        self.continuity[i] = getattr(d, "continuity", 0)
        self.spec_margin_min[i] = getattr(d, "speculative_margin", 0.1)
        self.spec_margin_max[i] = getattr(d, "speculative_margin_max", 3.0e38)
        self.sleep_timer[i] = 0.0
        return i

    def remove(self, handle: int) -> None:
        self.kind[handle] = KIND_EMPTY
        self.awake[handle] = False
        self.shape[handle] = -1
        self._free.append(handle)

    @property
    def count(self) -> int:
        return self.capacity - len(self._free)

    _FIELDS = ("px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz", "wx", "wy", "wz",
               "inv_mass", "ixx", "iyx", "iyy", "izx", "izy", "izz", "kind", "awake", "shape",
               "friction", "spring_frequency", "spring_damping", "max_recovery_velocity",
               "sleep_threshold", "sleep_timer", "sleep_island", "collision_group",
               "continuity", "spec_margin_min", "spec_margin_max")

    def device(self, device) -> BodyState:
        """The columns on ``device``: one copy per dtype."""
        groups = {}
        for f in self._FIELDS:
            a = getattr(self, f)
            groups.setdefault(a.dtype.str, []).append(f)
        t = {}
        for names in groups.values():
            block = to_device(np.stack([getattr(self, f) for f in names]), device)
            t.update(zip(names, block))
        return BodyState(
            pos=Vec3(t["px"], t["py"], t["pz"]),
            orn=Quat(t["qx"], t["qy"], t["qz"], t["qw"]),
            vel=Vec3(t["vx"], t["vy"], t["vz"]),
            omega=Vec3(t["wx"], t["wy"], t["wz"]),
            inv_mass=t["inv_mass"],
            inv_inertia=Sym3(t["ixx"], t["iyx"], t["iyy"], t["izx"], t["izy"], t["izz"]),
            **{f: t[f] for f in ("kind", "awake", "shape", "friction", "spring_frequency",
                                 "spring_damping", "max_recovery_velocity",
                                 "sleep_threshold", "sleep_timer", "sleep_island",
                                 "collision_group", "continuity", "spec_margin_min",
                                 "spec_margin_max")},
        )

    def load(self, state: BodyState) -> None:
        """Pull device state back into (writable) host arrays after stepping: one copy
        for the float columns and one for the others."""
        floats = torch.stack([*state.pos, *state.orn, *state.vel, *state.omega,
                              state.sleep_timer]).cpu().numpy()
        ints = torch.stack([state.awake.to(torch.int32), state.sleep_island]).cpu().numpy()
        (self.px, self.py, self.pz, self.qx, self.qy, self.qz, self.qw, self.vx, self.vy,
         self.vz, self.wx, self.wy, self.wz, self.sleep_timer) = (r.copy() for r in floats)
        self.awake = ints[0].astype(bool)
        self.sleep_island = ints[1].copy()
