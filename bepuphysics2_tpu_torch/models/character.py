"""Character controller (reference Demos/Characters/CharacterControllers.cs:85): a capsule
with its rotation locked, driven by a horizontal velocity motor, with ground support found
by a ray cast.

Counterpart of ``bepuphysics2_tpu/models/character.py``, composed from public pieces as
there: the capsule's inverse inertia is zero (it never tips), support is a scene ray cast
under it that skips the capsule itself, movement sets the target of a one-body linear
motor whose force is limited (it cannot climb walls), and a jump sets the vertical
velocity. Each ``supported()`` reads one ray's result to the host.
"""
from __future__ import annotations

from ..bodies import BodyDescription
from ..constraints.joints import MotorSettingsDesc
from ..shapes import Capsule


class Character:
    def __init__(self, sim, position=(0, 1.0, 0), radius=0.3, height=1.0, mass=1.0,
                 max_force=20.0):
        self.sim = sim
        self.shape_obj = Capsule(radius, height * 0.5)
        shape = sim.add_shape(self.shape_obj)
        self.radius = radius
        self.half_height = height * 0.5 + radius
        self.body = sim.add_body(
            BodyDescription(
                position=position, shape=shape, inv_mass=1.0 / mass,
                inv_inertia=(0.0,) * 6,  # rotation locked: the character never tips
                friction=0.3, sleep_threshold=-1.0,
            )
        )
        self.max_force = max_force
        self._motor = sim.add_constraint(
            "one_body_linear_motor", [self.body],
            local_offset=(0, 0, 0), target_velocity=(0, 0, 0),
            motor=MotorSettingsDesc(maximum_force=0.0, softness=0.05),
        )

    def supported(self) -> bool:
        pos, _, _, _ = self.sim.get_body(self.body)
        hit = self.sim.ray_cast(
            pos, (0.0, -1.0, 0.0), self.half_height + 0.1, exclude=self.body
        )
        return bool(hit.hit)

    def move(self, target_velocity_xz, jump_speed: float = 0.0):
        """Once per control tick: set the horizontal velocity target; optionally jump."""
        supported = self.supported()
        pos, _, vel, _ = self.sim.get_body(self.body)
        tx, tz = target_velocity_xz
        jumping = jump_speed > 0.0 and supported
        # The motor is a 3-DOF velocity servo whose vertical target would fight gravity in
        # flight (the reference's CharacterMotionConstraint acts in the tangent plane
        # only): a jump tick turns it off, and the next move() turns it back on.
        force = 0.0 if jumping else (self.max_force if supported else self.max_force * 0.1)
        self.sim.update_constraint(
            self._motor,
            local_offset=(0, 0, 0),
            target_velocity=(float(tx), float(vel[1]), float(tz)),
            motor=MotorSettingsDesc(maximum_force=force, softness=0.05),
        )
        if jumping:
            self.sim.set_velocity(self.body, linear=(vel[0], jump_speed, vel[2]))
