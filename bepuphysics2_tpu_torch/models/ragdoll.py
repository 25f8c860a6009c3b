"""Ragdoll assembly, the port's own copy of ``bepuphysics2_tpu/models/ragdoll.py`` (the
reference RagdollDemo, Demos/Demos/RagdollDemo.cs): capsule and sphere limbs linked by
ball sockets with swing limits, built through the public ``Simulation`` API."""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription
from ..shapes import Capsule, Sphere


def add_ragdoll(sim, position=(0.0, 0.0, 0.0), mass: float = 1.0):
    """Builds an ~9-body humanoid ragdoll. Returns dict of body handles."""
    px, py, pz = position

    def capsule(r, hl):
        return sim.add_shape(Capsule(r, hl)), Capsule(r, hl)

    def add(pos, shape_id, shape_obj, m):
        return sim.add_body(
            BodyDescription.dynamic(pos, shape_id, m, shape_obj, sleep_threshold=0.02)
        )

    torso_s, torso_o = capsule(0.22, 0.25)
    head_s, head_o = sim.add_shape(Sphere(0.16)), Sphere(0.16)
    upper_arm_s, upper_arm_o = capsule(0.08, 0.15)
    lower_arm_s, lower_arm_o = capsule(0.07, 0.14)
    upper_leg_s, upper_leg_o = capsule(0.1, 0.18)
    lower_leg_s, lower_leg_o = capsule(0.09, 0.18)

    bodies = {}
    bodies["torso"] = add((px, py + 1.2, pz), torso_s, torso_o, mass * 3)
    bodies["head"] = add((px, py + 1.75, pz), head_s, head_o, mass * 0.8)
    bodies["upper_arm_l"] = add((px - 0.42, py + 1.35, pz), upper_arm_s, upper_arm_o, mass)
    bodies["upper_arm_r"] = add((px + 0.42, py + 1.35, pz), upper_arm_s, upper_arm_o, mass)
    bodies["lower_arm_l"] = add((px - 0.8, py + 1.35, pz), lower_arm_s, lower_arm_o, mass * 0.7)
    bodies["lower_arm_r"] = add((px + 0.8, py + 1.35, pz), lower_arm_s, lower_arm_o, mass * 0.7)
    bodies["upper_leg_l"] = add((px - 0.15, py + 0.65, pz), upper_leg_s, upper_leg_o, mass * 1.5)
    bodies["upper_leg_r"] = add((px + 0.15, py + 0.65, pz), upper_leg_s, upper_leg_o, mass * 1.5)
    bodies["lower_leg_l"] = add((px - 0.15, py + 0.2, pz), lower_leg_s, lower_leg_o, mass)
    bodies["lower_leg_r"] = add((px + 0.15, py + 0.2, pz), lower_leg_s, lower_leg_o, mass)

    def socket(a, b, anchor_world, swing_axis_a, swing_axis_b, max_swing_deg):
        pa, _, _, _ = sim.get_body(a)
        pb, _, _, _ = sim.get_body(b)
        anchor = np.asarray(anchor_world)
        sim.add_constraint(
            "ball_socket", [a, b],
            local_offset_a=tuple(anchor - pa), local_offset_b=tuple(anchor - pb),
            spring_frequency=30.0,
        )
        sim.add_constraint(
            "swing_limit", [a, b],
            axis_local_a=swing_axis_a, axis_local_b=swing_axis_b,
            minimum_dot=float(np.cos(np.radians(max_swing_deg))),
            spring_frequency=30.0,
        )

    socket(bodies["torso"], bodies["head"], (px, py + 1.55, pz), (0, 1, 0), (0, 1, 0), 40)
    socket(bodies["torso"], bodies["upper_arm_l"], (px - 0.27, py + 1.45, pz), (-1, 0, 0), (0, 1, 0), 80)
    socket(bodies["torso"], bodies["upper_arm_r"], (px + 0.27, py + 1.45, pz), (1, 0, 0), (0, 1, 0), 80)
    socket(bodies["upper_arm_l"], bodies["lower_arm_l"], (px - 0.6, py + 1.35, pz), (0, 1, 0), (0, 1, 0), 75)
    socket(bodies["upper_arm_r"], bodies["lower_arm_r"], (px + 0.6, py + 1.35, pz), (0, 1, 0), (0, 1, 0), 75)
    socket(bodies["torso"], bodies["upper_leg_l"], (px - 0.15, py + 0.9, pz), (0, -1, 0), (0, 1, 0), 70)
    socket(bodies["torso"], bodies["upper_leg_r"], (px + 0.15, py + 0.9, pz), (0, -1, 0), (0, 1, 0), 70)
    socket(bodies["upper_leg_l"], bodies["lower_leg_l"], (px - 0.15, py + 0.42, pz), (0, 1, 0), (0, 1, 0), 80)
    socket(bodies["upper_leg_r"], bodies["lower_leg_r"], (px + 0.15, py + 0.42, pz), (0, 1, 0), (0, 1, 0), 80)
    return bodies
