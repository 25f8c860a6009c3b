"""The car (reference Demos/Demos/Cars/SimpleCarDemo's suspension recipe: per wheel a
PointOnLineServo suspension track, a LinearAxisServo spring, an AngularHinge wheel axis and
an AngularAxisMotor drive).

The port's copy of ``bepuphysics2_tpu/models/vehicle.py``, built through the port's
``Simulation`` API; its wheels are cylinders, which collide through the generic GJK/MPR
narrow phase."""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription
from ..shapes import Box, Cylinder
from ..constraints.joints import MotorSettingsDesc, ServoSettingsDesc


class SimpleCar:
    """4-wheeled car with servo suspension and axis motors. Use ``set_drive`` each control
    tick to steer/accelerate."""

    def __init__(self, sim, position=(0, 1.0, 0), body_mass=10.0, wheel_mass=1.0):
        self.sim = sim
        px, py, pz = position
        # Car parts share one collision group so wheels never rub the chassis (reference
        # demos filter car-internal pairs via SubgroupCollisionFilter).
        group = sim.new_collision_group()
        chassis = Box(1.0, 0.3, 2.0)
        chassis_s = sim.add_shape(chassis)
        self.body = sim.add_body(
            BodyDescription.dynamic(
                (px, py, pz), chassis_s, body_mass, chassis, collision_group=group
            )
        )
        wheel = Cylinder(0.35, 0.15)
        wheel_s = sim.add_shape(wheel)
        # Wheel cylinders' axis is local Y; rotate so it points along world X (roll axis).
        q = (0.0, 0.0, -np.sin(np.pi / 4), np.cos(np.pi / 4))
        self.wheels = []
        self.motors = []
        self.steers = []
        offsets = [(-1.05, -0.3, 1.4), (1.05, -0.3, 1.4), (-1.05, -0.3, -1.4), (1.05, -0.3, -1.4)]
        for k, (ox, oy, oz) in enumerate(offsets):
            w = sim.add_body(
                BodyDescription.dynamic(
                    (px + ox, py + oy, pz + oz), wheel_s, wheel_mass, wheel,
                    orientation=q, friction=1.5, sleep_threshold=-1.0,
                    collision_group=group,
                )
            )
            self.wheels.append(w)
            # Suspension: wheel rides a vertical line fixed on the chassis...
            sim.add_constraint(
                "point_on_line_servo", [self.body, w],
                local_offset_a=(ox, oy + 0.3, oz), local_offset_b=(0, 0, 0),
                local_direction=(0, -1, 0),
                spring_frequency=30.0, spring_damping=1.0,
                servo=ServoSettingsDesc(),
            )
            # Suspension spring: target offset along the track.
            sim.add_constraint(
                "linear_axis_servo", [self.body, w],
                local_offset_a=(ox, oy + 0.3, oz), local_offset_b=(0, 0, 0),
                local_plane_normal=(0, -1, 0), target_offset=0.3,
                spring_frequency=4.0, spring_damping=0.7,
                servo=ServoSettingsDesc(),
            )
            # Keep the wheel's spin axis aligned with the chassis X axis.
            sim.add_constraint(
                "angular_hinge", [self.body, w],
                local_hinge_axis_a=(1, 0, 0), local_hinge_axis_b=(0, 1, 0),
                spring_frequency=30.0, spring_damping=1.0,
            )
            # Drive motor about the wheel axis.
            m = sim.add_constraint(
                "angular_axis_motor", [self.body, w],
                local_axis_a=(1, 0, 0), target_velocity=0.0,
                motor=MotorSettingsDesc(maximum_force=30.0, softness=0.02),
            )
            self.motors.append(m)

    def set_drive(self, speed: float):
        """Target angular velocity of all wheels (rad/s; negative = forward -z or +z
        depending on wheel orientation)."""
        for m in self.motors:
            self.sim.update_constraint(
                m, local_axis_a=(1, 0, 0), target_velocity=float(speed),
                motor=MotorSettingsDesc(maximum_force=30.0, softness=0.02),
            )
