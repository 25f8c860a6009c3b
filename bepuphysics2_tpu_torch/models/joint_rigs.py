"""Every joint type in one scene, the reference ConstraintTestDemo matrix
(Demos/SpecializedTests/ConstraintTestDemo.cs): the port's copy of the rig battery of
``tests/test_joint_behavior.py``.

Each rig is an isolated pair (a kinematic anchor and a dynamic bob, no collision shapes)
25 m from the next, in a zero-gravity world; the area and volume rigs hold three and four
dynamic bodies. After 150 steps each constrained degree of freedom must have converged:
servos reach their target, motors the target velocity (with the reference's (A - B)
relative-velocity sign), limits clamp into asymmetric ranges, and geometric constraints
restore their invariant from a violated start.
"""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription
from ..integrator import IntegratorConfig
from ..shapes import Sphere
from ..simulation import SimConfig, Simulation


def _q_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return (axis[0] * s, axis[1] * s, axis[2] * s, float(np.cos(angle / 2.0)))


def _q_rotate(q, v):
    x, y, z, w = q
    u = np.array([x, y, z])
    v = np.asarray(v, np.float64)
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _q_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    )


def _q_conj(q):
    return (-q[0], -q[1], -q[2], q[3])


SPRING = dict(spring_frequency=20.0, spring_damping=1.0)


class Rigs:
    """Builds every rig into one simulation and registers per-rig assertions."""

    def __init__(self, sim, inertia_shape):
        self.sim = sim
        self.shape = inertia_shape
        self.x = 0.0
        self.checks = []

    def pair(self, b_offset=(1.0, 0.0, 0.0), b_orn=(0, 0, 0, 1), kin_vel=None):
        o = (self.x, 0.0, 0.0)
        self.x += 25.0
        a = self.sim.add_body(BodyDescription.kinematic(o))
        b = self.sim.add_body(
            BodyDescription.dynamic(
                (o[0] + b_offset[0], o[1] + b_offset[1], o[2] + b_offset[2]),
                -1, 1.0, self.shape, orientation=b_orn,
            )
        )
        if kin_vel is not None:
            self.sim.set_velocity(a, linear=kin_vel[0], angular=kin_vel[1])
        return o, a, b

    def lone(self, orn=(0, 0, 0, 1)):
        o = (self.x, 0.0, 0.0)
        self.x += 25.0
        b = self.sim.add_body(
            BodyDescription.dynamic(o, -1, 1.0, self.shape, orientation=orn)
        )
        return o, b

    def check(self, name, fn):
        self.checks.append((name, fn))


def build_joint_rigs(device="cuda", steps: int = 150):
    """The rig scene: every joint type in one zero-gravity simulation on ``device``,
    stepped ``steps`` frames. Returns the ``Rigs`` (its ``sim`` and its ``checks``, one
    ``(name, fn)`` per rig; ``fn()`` raises ``AssertionError`` if the rig has not
    converged)."""
    sim = Simulation(SimConfig(body_capacity=128, max_pairs=64, substeps=4, num_colors=4,
                               joint_capacity=4, enable_sleep=False,
                               integrator=IntegratorConfig(gravity=(0.0, 0.0, 0.0))),
                     device=device)
    shape = Sphere(0.5)
    R = Rigs(sim, shape)
    add = sim.add_constraint

    def body(h):
        pos, orn, vel, omega = sim.get_body(h)
        return np.asarray(pos), np.asarray(orn), np.asarray(vel), np.asarray(omega)

    # --- linear family -----------------------------------------------------------------
    # ball_socket: anchors must coincide from a separated start.
    o, a, b = R.pair(b_offset=(1.4, 0.3, 0.0))
    add("ball_socket", [a, b], local_offset_a=(0.5, 0, 0), local_offset_b=(-0.5, 0, 0), **SPRING)
    def _ball(o=o, a=a, b=b):
        pb, qb, _, _ = body(b)
        anchor_a = np.asarray(o) + (0.5, 0, 0)
        anchor_b = pb + _q_rotate(qb, (-0.5, 0, 0))
        assert np.linalg.norm(anchor_a - anchor_b) < 0.03
    R.check("ball_socket", _ball)

    # ball_socket_servo: same invariant through the servo path.
    o, a, b = R.pair(b_offset=(1.6, -0.2, 0.0))
    add("ball_socket_servo", [a, b], local_offset_a=(0.5, 0, 0), local_offset_b=(-0.5, 0, 0), **SPRING)
    def _bss(o=o, b=b):
        pb, qb, _, _ = body(b)
        assert np.linalg.norm(np.asarray(o) + (0.5, 0, 0) - (pb + _q_rotate(qb, (-0.5, 0, 0)))) < 0.05
    R.check("ball_socket_servo", _bss)

    # ball_socket_motor: target = relative velocity (A − B) at B's anchor -> with A
    # kinematic at rest, B's velocity converges to −target.
    o, a, b = R.pair(b_offset=(1.0, 0.0, 0.0))
    add("ball_socket_motor", [a, b], local_offset_b=(0, 0, 0), target_velocity=(0.0, -0.4, 0.0))
    def _bsm(b=b):
        _, _, vb, _ = body(b)
        assert np.linalg.norm(vb - (0.0, 0.4, 0.0)) < 0.05, vb
    R.check("ball_socket_motor", _bsm)

    # distance_servo: anchor distance -> target.
    o, a, b = R.pair(b_offset=(3.0, 0.0, 0.0))
    add("distance_servo", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        target_distance=2.0, **SPRING)
    def _ds(o=o, b=b):
        pb, _, _, _ = body(b)
        assert abs(np.linalg.norm(pb - o) - 2.0) < 0.05
    R.check("distance_servo", _ds)

    # distance_limit: asymmetric [1, 2]; starts outside at 2.8 -> clamps under the max.
    o, a, b = R.pair(b_offset=(2.8, 0.0, 0.0))
    add("distance_limit", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        minimum_distance=1.0, maximum_distance=2.0, **SPRING)
    def _dl(o=o, b=b):
        pb, _, _, _ = body(b)
        d = np.linalg.norm(pb - o)
        assert 0.9 < d < 2.1, d
    R.check("distance_limit", _dl)

    # center_distance: center separation -> target.
    o, a, b = R.pair(b_offset=(3.2, 0.0, 0.0))
    add("center_distance", [a, b], target_distance=2.0, **SPRING)
    def _cd(o=o, b=b):
        pb, _, _, _ = body(b)
        assert abs(np.linalg.norm(pb - o) - 2.0) < 0.05
    R.check("center_distance", _cd)

    # center_distance_limit: [1, 2] from 2.6.
    o, a, b = R.pair(b_offset=(2.6, 0.0, 0.0))
    add("center_distance_limit", [a, b], minimum_distance=1.0, maximum_distance=2.0, **SPRING)
    def _cdl(o=o, b=b):
        pb, _, _, _ = body(b)
        d = np.linalg.norm(pb - o)
        assert 0.9 < d < 2.1, d
    R.check("center_distance_limit", _cdl)

    # weld: pose lock at offset (1,0,0), identity orientation, from a perturbed start.
    o, a, b = R.pair(b_offset=(1.35, 0.25, 0.0), b_orn=_q_axis_angle((0, 0, 1), 0.4))
    add("weld", [a, b], local_offset=(1.0, 0.0, 0.0), local_orientation=(0, 0, 0, 1), **SPRING)
    def _weld(o=o, b=b):
        pb, qb, _, _ = body(b)
        assert np.linalg.norm(pb - (np.asarray(o) + (1.0, 0, 0))) < 0.05
        assert abs(qb[3]) > 0.999  # identity orientation
    R.check("weld", _weld)

    # point_on_line_servo: B's anchor pulled onto A's y line.
    o, a, b = R.pair(b_offset=(0.8, 0.6, 0.0))
    add("point_on_line_servo", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        local_direction=(0, 1, 0), **SPRING)
    def _pol(o=o, b=b):
        pb, _, _, _ = body(b)
        assert abs(pb[0] - o[0]) < 0.03 and abs(pb[2] - o[2]) < 0.03
    R.check("point_on_line_servo", _pol)

    # linear_axis_servo: offset along the plane normal (y) -> target 0.5.
    o, a, b = R.pair(b_offset=(0.0, 1.6, 0.0))
    add("linear_axis_servo", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        local_plane_normal=(0, 1, 0), target_offset=0.5, **SPRING)
    def _las(o=o, b=b):
        pb, _, _, _ = body(b)
        assert abs((pb[1] - o[1]) - 0.5) < 0.05
    R.check("linear_axis_servo", _las)

    # linear_axis_motor: csv = (vA − vB)·axis -> target; A fixed => vB·y -> −target.
    o, a, b = R.pair(b_offset=(0.0, 1.0, 0.0))
    add("linear_axis_motor", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        local_axis=(0, 1, 0), target_velocity=0.4)
    def _lam(b=b):
        _, _, vb, _ = body(b)
        assert abs(vb[1] + 0.4) < 0.05, vb
    R.check("linear_axis_motor", _lam)

    # linear_axis_limit: y offset clamps into asymmetric [0.5, 1.5] from 2.4.
    o, a, b = R.pair(b_offset=(0.0, 2.4, 0.0))
    add("linear_axis_limit", [a, b], local_offset_a=(0, 0, 0), local_offset_b=(0, 0, 0),
        local_axis=(0, 1, 0), minimum_offset=0.5, maximum_offset=1.5, **SPRING)
    def _lal(o=o, b=b):
        pb, _, _, _ = body(b)
        off = pb[1] - o[1]
        assert 0.4 < off < 1.6, off
    R.check("linear_axis_limit", _lal)

    # --- angular family ----------------------------------------------------------------
    # angular_hinge: hinge axes realign from a tilted start.
    o, a, b = R.pair(b_offset=(1.0, 0, 0), b_orn=_q_axis_angle((1, 0, 0), 0.5))
    add("angular_hinge", [a, b], local_hinge_axis_a=(0, 1, 0), local_hinge_axis_b=(0, 1, 0), **SPRING)
    def _ah(b=b):
        _, qb, _, _ = body(b)
        axis_b = _q_rotate(qb, (0, 1, 0))
        assert axis_b[1] > 0.995, axis_b
    R.check("angular_hinge", _ah)

    # angular_swivel_hinge: swivel x (A) ⟂ hinge y (B) restored from a violated start.
    o, a, b = R.pair(b_offset=(1.0, 0, 0), b_orn=_q_axis_angle((0, 0, 1), 0.6))
    add("angular_swivel_hinge", [a, b], local_swivel_axis_a=(1, 0, 0), local_hinge_axis_b=(0, 1, 0), **SPRING)
    def _ash(b=b):
        _, qb, _, _ = body(b)
        hinge_b = _q_rotate(qb, (0, 1, 0))
        assert abs(np.dot((1, 0, 0), hinge_b)) < 0.03
    R.check("angular_swivel_hinge", _ash)

    # swing_limit: swing angle pushed back within the cone (min_dot = cos 0.5).
    o, a, b = R.pair(b_offset=(1.0, 0, 0), b_orn=_q_axis_angle((1, 0, 0), 1.1))
    add("swing_limit", [a, b], axis_local_a=(0, 1, 0), axis_local_b=(0, 1, 0),
        minimum_dot=float(np.cos(0.5)), **SPRING)
    def _sl(b=b):
        _, qb, _, _ = body(b)
        dot = _q_rotate(qb, (0, 1, 0))[1]
        assert dot > np.cos(0.5) - 0.05, dot
    R.check("swing_limit", _sl)

    # twist_servo: drive the twist about shared z back to zero from a twisted start.
    o, a, b = R.pair(b_offset=(1.0, 0, 0), b_orn=_q_axis_angle((0, 0, 1), 0.7))
    add("twist_servo", [a, b], local_basis_a=(0, 0, 0, 1), local_basis_b=(0, 0, 0, 1),
        target_angle=0.0, **SPRING)
    def _ts(b=b):
        _, qb, _, _ = body(b)
        # relative rotation must be near identity about z (twist removed).
        assert abs(qb[2]) < 0.03, qb
    R.check("twist_servo", _ts)

    # twist_limit: asymmetric [0.2, 0.8] from 1.4 — sign-sensitive clamp.
    o, a, b = R.pair(b_offset=(1.0, 0, 0), b_orn=_q_axis_angle((0, 0, 1), 1.4))
    add("twist_limit", [a, b], local_basis_a=(0, 0, 0, 1), local_basis_b=(0, 0, 0, 1),
        minimum_angle=0.2, maximum_angle=0.8, **SPRING)
    def _tl(b=b):
        _, qb, _, _ = body(b)
        angle = 2.0 * np.arctan2(qb[2], qb[3])
        assert 0.1 < angle < 0.9, angle
    R.check("twist_limit", _tl)

    # twist_motor: csv = (wA − wB)·axis -> target; A fixed => wB·z -> −target.
    o, a, b = R.pair()
    add("twist_motor", [a, b], local_axis_a=(0, 0, 1), local_axis_b=(0, 0, 1),
        target_velocity=0.6)
    def _tm(b=b):
        _, _, _, wb = body(b)
        assert abs(wb[2] + 0.6) < 0.05, wb
    R.check("twist_motor", _tm)

    # angular_servo: relative orientation -> rotation of 0.6 about y.
    o, a, b = R.pair()
    add("angular_servo", [a, b], target_relative_rotation=_q_axis_angle((0, 1, 0), 0.6), **SPRING)
    def _as(b=b):
        _, qb, _, _ = body(b)
        target = np.asarray(_q_axis_angle((0, 1, 0), 0.6))
        err = _q_mul(_q_conj(tuple(target)), tuple(qb))
        assert abs(err[3]) > 0.999, qb
    R.check("angular_servo", _as)

    # angular_motor: (wA − wB) -> target; A fixed => wB -> −target.
    o, a, b = R.pair()
    add("angular_motor", [a, b], target_velocity=(0.0, 0.5, 0.0))
    def _am(b=b):
        _, _, _, wb = body(b)
        assert np.linalg.norm(wb - (0.0, -0.5, 0.0)) < 0.05, wb
    R.check("angular_motor", _am)

    # angular_axis_motor: (wA − wB)·axis -> target; A fixed => wB·y -> −target.
    o, a, b = R.pair()
    add("angular_axis_motor", [a, b], local_axis_a=(0, 1, 0), target_velocity=0.8)
    def _aam(b=b):
        _, _, _, wb = body(b)
        assert abs(wb[1] + 0.8) < 0.05, wb
    R.check("angular_axis_motor", _aam)

    # angular_axis_gear_motor: wB·axis = velocity_scale × wA·axis with A spinning.
    o, a, b = R.pair(kin_vel=((0, 0, 0), (0.0, 0.5, 0.0)))
    add("angular_axis_gear_motor", [a, b], local_axis_a=(0, 1, 0), velocity_scale=2.0)
    def _gear(b=b):
        _, _, _, wb = body(b)
        assert abs(wb[1] - 1.0) < 0.06, wb
    R.check("angular_axis_gear_motor", _gear)

    # hinge: anchors coincide + axes align, door-style.
    o, a, b = R.pair(b_offset=(1.3, 0.4, 0.1), b_orn=_q_axis_angle((1, 0, 0), 0.3))
    add("hinge", [a, b], local_offset_a=(0.5, 0, 0), local_hinge_axis_a=(0, 1, 0),
        local_offset_b=(-0.5, 0, 0), local_hinge_axis_b=(0, 1, 0), **SPRING)
    def _hinge(o=o, b=b):
        pb, qb, _, _ = body(b)
        anchor_b = pb + _q_rotate(qb, (-0.5, 0, 0))
        assert np.linalg.norm(np.asarray(o) + (0.5, 0, 0) - anchor_b) < 0.05
        assert _q_rotate(qb, (0, 1, 0))[1] > 0.995
    R.check("hinge", _hinge)

    # swivel_hinge: anchor connection + swivel ⟂ hinge.
    o, a, b = R.pair(b_offset=(1.4, 0.2, 0.0), b_orn=_q_axis_angle((0, 0, 1), 0.4))
    add("swivel_hinge", [a, b], local_offset_a=(0.5, 0, 0), local_swivel_axis_a=(1, 0, 0),
        local_offset_b=(-0.5, 0, 0), local_hinge_axis_b=(0, 1, 0), **SPRING)
    def _sh(o=o, b=b):
        pb, qb, _, _ = body(b)
        anchor_b = pb + _q_rotate(qb, (-0.5, 0, 0))
        assert np.linalg.norm(np.asarray(o) + (0.5, 0, 0) - anchor_b) < 0.05
        assert abs(np.dot((1, 0, 0), _q_rotate(qb, (0, 1, 0)))) < 0.05
    R.check("swivel_hinge", _sh)

    # --- one-body family ---------------------------------------------------------------
    o, b = R.lone()
    add("one_body_linear_servo", [b], local_offset=(0, 0, 0),
        target=(o[0] + 0.6, 0.4, 0.0), **SPRING)
    def _obls(o=o, b=b):
        pb, _, _, _ = body(b)
        assert np.linalg.norm(pb - (o[0] + 0.6, 0.4, 0.0)) < 0.05, pb
    R.check("one_body_linear_servo", _obls)

    o, b = R.lone()
    add("one_body_linear_motor", [b], local_offset=(0, 0, 0), target_velocity=(0.3, 0.0, 0.2))
    def _oblm(b=b):
        _, _, vb, _ = body(b)
        assert np.linalg.norm(vb - (0.3, 0.0, 0.2)) < 0.05, vb
    R.check("one_body_linear_motor", _oblm)

    o, b = R.lone(orn=_q_axis_angle((0, 1, 0), 0.8))
    add("one_body_angular_servo", [b], target_orientation=(0, 0, 0, 1), **SPRING)
    def _obas(b=b):
        _, qb, _, _ = body(b)
        assert abs(qb[3]) > 0.999, qb
    R.check("one_body_angular_servo", _obas)

    o, b = R.lone()
    add("one_body_angular_motor", [b], target_velocity=(0.0, 0.7, 0.0))
    def _obam(b=b):
        _, _, _, wb = body(b)
        assert np.linalg.norm(wb - (0.0, 0.7, 0.0)) < 0.05, wb
    R.check("one_body_angular_motor", _obam)

    # --- multibody family ----------------------------------------------------------------
    # area: triangle of three dynamics, scaled area (|AB×AC| = 2·area) -> target.
    o = (R.x, 0.0, 0.0); R.x += 25.0
    tri = [
        sim.add_body(BodyDescription.dynamic((o[0] + dx, dy, dz), -1, 1.0, shape))
        for dx, dy, dz in [(0, 0, 0), (2.0, 0, 0), (0, 2.0, 0)]
    ]
    area0 = 0.5 * 2.0 * 2.0  # right triangle legs 2,2
    target_area = 2.0 * area0 * 0.6  # scaled = 2·area, shrunk 40%
    add("area", tri, target_scaled_area=float(target_area), **SPRING)
    def _area(tri=tri, target=target_area):
        ps = [body(h)[0] for h in tri]
        scaled = np.linalg.norm(np.cross(ps[1] - ps[0], ps[2] - ps[0]))
        assert abs(scaled - target) < 0.12 * target, (scaled, target)
    R.check("area", _area)

    # volume: tetrahedron, scaled volume ((AB×AC)·AD = 6·volume) -> target.
    o = (R.x, 0.0, 0.0); R.x += 25.0
    tet = [
        sim.add_body(BodyDescription.dynamic((o[0] + dx, dy, dz), -1, 1.0, shape))
        for dx, dy, dz in [(0, 0, 0), (1.5, 0, 0), (0, 1.5, 0), (0, 0, 1.5)]
    ]
    scaled_vol0 = 1.5 ** 3  # (AB×AC)·AD for the right tetra
    target_vol = scaled_vol0 * 0.6
    add("volume", tet, target_scaled_volume=float(target_vol), **SPRING)
    def _vol(tet=tet, target=target_vol):
        ps = [body(h)[0] for h in tet]
        scaled = np.dot(np.cross(ps[1] - ps[0], ps[2] - ps[0]), ps[3] - ps[0])
        assert abs(scaled - target) < 0.12 * target, (scaled, target)
    R.check("volume", _vol)

    sim.run(steps, 1.0 / 60.0)
    return R


ALL_NAMES = [
    "ball_socket", "ball_socket_servo", "ball_socket_motor", "distance_servo",
    "distance_limit", "center_distance", "center_distance_limit", "weld",
    "point_on_line_servo", "linear_axis_servo", "linear_axis_motor",
    "linear_axis_limit", "angular_hinge", "angular_swivel_hinge", "swing_limit",
    "twist_servo", "twist_limit", "twist_motor", "angular_servo", "angular_motor",
    "angular_axis_motor", "angular_axis_gear_motor", "hinge", "swivel_hinge",
    "one_body_linear_servo", "one_body_linear_motor", "one_body_angular_servo",
    "one_body_angular_motor", "area", "volume",
]


