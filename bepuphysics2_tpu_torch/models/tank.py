"""Tank assembly — tracked (skid-steer) drive + aimable turret/barrel + projectile fire.

Capability parity with the reference's tank library (Demos/Demos/Tanks/Tank.cs):
- per wheel: LinearAxisServo suspension spring + PointOnLineServo track +
  AngularHinge spin-axis alignment + AngularAxisMotor drive (Tank.cs:184 CreateWheel);
- tracked steering: independent left/right motor groups — differential target
  velocities skid-steer the hull (TankController semantics);
- turret: Hinge to the hull about the swivel axis + TwistServo aiming the swivel
  angle; barrel: Hinge to the turret about the pitch axis + TwistServo aiming pitch
  (Tank.cs:286-330 — "servo-like control over 1 angular DOF requires a measurement
  basis", realized here with the same hinge+twist_servo pairing);
- ``fire()``: spawns a fast projectile at the barrel tip along the barrel direction
  with continuous collision detection enabled (Tank.cs:157-176 Fire).

All parts share one collision group (the reference's SubgroupCollisionFilter keyed by
the hull handle, Tank.cs:272-277).

The port's copy of ``bepuphysics2_tpu/models/tank.py``, built through the port's
``Simulation`` API. ``fire`` marks its projectile continuous: with ``max_ccd_pairs > 0``
its pairs are swept to their time of impact (kernel K8 on the card), as in the JAX
package; at ``max_ccd_pairs`` 0 it collides through speculative contacts alone."""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription
from ..shapes import Box, Cylinder, Sphere
from ..constraints.joints import MotorSettingsDesc, ServoSettingsDesc


class Tank:
    """Tracked vehicle with an aimable turret. Drive each control tick with
    ``set_track_speeds(left, right)``; aim with ``set_aim(swivel, pitch)``; shoot with
    ``fire()``."""

    WHEEL_FORCE = 40.0

    def __init__(self, sim, position=(0.0, 1.2, 0.0), wheels_per_tread=4,
                 hull_mass=20.0, wheel_mass=1.0):
        self.sim = sim
        px, py, pz = position
        group = sim.new_collision_group()
        self.group = group

        hull = Box(1.6, 0.4, 2.8)
        hull_s = sim.add_shape(hull)
        self.body = sim.add_body(
            BodyDescription.dynamic(
                (px, py, pz), hull_s, hull_mass, hull, collision_group=group
            )
        )

        # --- turret: hinge about the hull's +Y at the turret anchor + twist servo
        # measuring/driving the swivel angle about that axis.
        turret = Box(0.9, 0.3, 1.1)
        turret_s = sim.add_shape(turret)
        self.turret = sim.add_body(
            BodyDescription.dynamic(
                (px, py + 0.45, pz - 0.2), turret_s, hull_mass * 0.25, turret,
                collision_group=group,
            )
        )
        sim.add_constraint(
            "hinge", [self.body, self.turret],
            local_offset_a=(0.0, 0.45, -0.2), local_offset_b=(0.0, 0.0, 0.0),
            local_hinge_axis_a=(0, 1, 0), local_hinge_axis_b=(0, 1, 0),
            spring_frequency=30.0, spring_damping=1.0,
        )
        self._turret_servo = sim.add_constraint(
            "twist_servo", [self.body, self.turret],
            local_basis_a=_twist_basis((0, 1, 0), (0, 0, -1)),
            local_basis_b=_twist_basis((0, 1, 0), (0, 0, -1)),
            target_angle=0.0,
            spring_frequency=20.0, spring_damping=1.0,
            servo=ServoSettingsDesc(maximum_force=200.0),
        )

        # --- barrel: hinge about the turret's +X (pitch) + twist servo for the angle.
        barrel = Box(0.12, 0.12, 1.4)
        barrel_s = sim.add_shape(barrel)
        self.barrel_len = 1.4
        self.barrel = sim.add_body(
            BodyDescription.dynamic(
                (px, py + 0.45, pz - 0.2 - 0.55 - 0.7), barrel_s, hull_mass * 0.05,
                barrel, collision_group=group,
            )
        )
        sim.add_constraint(
            "hinge", [self.turret, self.barrel],
            local_offset_a=(0.0, 0.0, -0.55), local_offset_b=(0.0, 0.0, 0.7),
            local_hinge_axis_a=(1, 0, 0), local_hinge_axis_b=(1, 0, 0),
            spring_frequency=30.0, spring_damping=1.0,
        )
        self._barrel_servo = sim.add_constraint(
            "twist_servo", [self.turret, self.barrel],
            local_basis_a=_twist_basis((1, 0, 0), (0, 0, -1)),
            local_basis_b=_twist_basis((1, 0, 0), (0, 0, -1)),
            target_angle=0.0,
            spring_frequency=20.0, spring_damping=1.0,
            servo=ServoSettingsDesc(maximum_force=100.0),
        )

        # --- treads: wheels_per_tread wheels per side, suspended like the reference's
        # CreateWheel (LinearAxisServo + PointOnLineServo + AngularHinge + motor).
        wheel = Cylinder(0.3, 0.2)
        wheel_s = sim.add_shape(wheel)
        qx = (0.0, 0.0, -np.sin(np.pi / 4), np.cos(np.pi / 4))  # cyl Y → world X
        self.wheels = []
        self.left_motors = []
        self.right_motors = []
        span = 2.2
        for side, sx in ((self.left_motors, -0.95), (self.right_motors, 0.95)):
            for k in range(wheels_per_tread):
                oz = -span / 2 + span * k / max(1, wheels_per_tread - 1)
                w = sim.add_body(
                    BodyDescription.dynamic(
                        (px + sx, py - 0.5, pz + oz), wheel_s, wheel_mass, wheel,
                        orientation=qx, friction=2.0, sleep_threshold=-1.0,
                        collision_group=group,
                    )
                )
                self.wheels.append(w)
                sim.add_constraint(
                    "point_on_line_servo", [self.body, w],
                    local_offset_a=(sx, -0.2, oz), local_offset_b=(0, 0, 0),
                    local_direction=(0, -1, 0),
                    spring_frequency=30.0, spring_damping=1.0,
                    servo=ServoSettingsDesc(),
                )
                sim.add_constraint(
                    "linear_axis_servo", [self.body, w],
                    local_offset_a=(sx, -0.2, oz), local_offset_b=(0, 0, 0),
                    local_plane_normal=(0, -1, 0), target_offset=0.3,
                    spring_frequency=5.0, spring_damping=1.0,
                    servo=ServoSettingsDesc(),
                )
                sim.add_constraint(
                    "angular_hinge", [self.body, w],
                    local_hinge_axis_a=(1, 0, 0), local_hinge_axis_b=(0, 1, 0),
                    spring_frequency=30.0, spring_damping=1.0,
                )
                m = sim.add_constraint(
                    "angular_axis_motor", [self.body, w],
                    local_axis_a=(1, 0, 0), target_velocity=0.0,
                    motor=MotorSettingsDesc(maximum_force=self.WHEEL_FORCE,
                                            softness=1e-3),
                )
                side.append(m)

        # Projectile plumbing (reference Tank.Fire): shape registered up front so
        # firing never re-registers (fixed shape table).
        self._proj_shape_obj = Sphere(0.1)
        self._proj_shape = sim.add_shape(self._proj_shape_obj)
        self.projectile_speed = 30.0

    # --- control -----------------------------------------------------------------------
    def set_track_speeds(self, left: float, right: float) -> None:
        """Target angular velocity (rad/s) per tread — differential speeds skid-steer
        (reference TankController: left/right motor lists driven independently)."""
        for m in self.left_motors:
            self.sim.update_constraint(
                m, local_axis_a=(1, 0, 0), target_velocity=float(left),
                motor=MotorSettingsDesc(maximum_force=self.WHEEL_FORCE, softness=1e-3),
            )
        for m in self.right_motors:
            self.sim.update_constraint(
                m, local_axis_a=(1, 0, 0), target_velocity=float(right),
                motor=MotorSettingsDesc(maximum_force=self.WHEEL_FORCE, softness=1e-3),
            )

    def set_aim(self, swivel_angle: float, pitch_angle: float) -> None:
        """Target turret swivel + barrel pitch angles (radians; reference Tank.SetAim)."""
        self.sim.update_constraint(
            self._turret_servo,
            local_basis_a=_twist_basis((0, 1, 0), (0, 0, -1)),
            local_basis_b=_twist_basis((0, 1, 0), (0, 0, -1)),
            target_angle=float(swivel_angle),
            spring_frequency=20.0, spring_damping=1.0,
            servo=ServoSettingsDesc(maximum_force=200.0),
        )
        self.sim.update_constraint(
            self._barrel_servo,
            local_basis_a=_twist_basis((1, 0, 0), (0, 0, -1)),
            local_basis_b=_twist_basis((1, 0, 0), (0, 0, -1)),
            target_angle=float(pitch_angle),
            spring_frequency=20.0, spring_damping=1.0,
            servo=ServoSettingsDesc(maximum_force=100.0),
        )

    def barrel_direction(self) -> np.ndarray:
        """World direction the barrel points (reference ComputeBarrelDirection)."""
        _, orn, _, _ = self.sim.get_body(self.barrel)
        return _rotate(orn, np.array([0.0, 0.0, -1.0]))

    def fire(self):
        """Spawn a fast projectile at the barrel tip, inheriting barrel velocity, with
        continuous collision detection on (reference Tank.Fire). Returns its handle."""
        pos, orn, vel, _ = self.sim.get_body(self.barrel)
        d = _rotate(orn, np.array([0.0, 0.0, -1.0]))
        spawn = pos + d * (self.barrel_len * 0.5 + 0.25)
        h = self.sim.add_body(
            BodyDescription.dynamic(
                tuple(spawn), self._proj_shape, 0.5, self._proj_shape_obj,
                velocity=tuple(d * self.projectile_speed + vel),
                continuity=1,
            )
        )
        return h


def _twist_basis(axis, measure):
    """Quaternion (x, y, z, w) of the twist-measurement basis: local Z = twist axis,
    local X = zero-angle direction (reference TwistServo basis construction,
    Tank.cs:295-308)."""
    z = np.asarray(axis, np.float64)
    x = np.asarray(measure, np.float64)
    x = x - z * (x @ z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.stack([x, y, z], axis=1)  # columns = basis vectors
    # Rotation matrix -> quaternion.
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return (
            float((m[2, 1] - m[1, 2]) / s), float((m[0, 2] - m[2, 0]) / s),
            float((m[1, 0] - m[0, 1]) / s), float(s / 4),
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[i] = s / 4
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return tuple(float(v) for v in q[:3]) + (float(q[3]),)


def _rotate(q, v):
    x, y, z, w = (float(c) for c in q)
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)
