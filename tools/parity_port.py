"""The trajectory-parity scenes of ``parity/run_parity.py`` through the PyTorch port, held
to that harness's own envelopes against its numpy oracles (``parity/oracles.py``, the
scalar TGS of ``run_parity.scalar_reference`` and the closed-form laws).

Scenes: the sphere dropped 2 m onto a static box (ballistic flight against the closed
form, settling and rest against the scalar reference), the sliding and spinning sphere,
the ball-socket pendulum, the two stacked boxes under a lateral force and the 3-link
hinge chain (conservation laws: energy never grows, the hinge axes and sockets stay
put). Each scene is built here from the port's public API exactly as ``run_parity.py``
builds it from the JAX package's, with the same constants; each envelope repeats the
thresholds of the ``run_parity.py`` function named beside it.

    python3 tools/parity_port.py [--device cpu|cuda] [--steps 1000]

prints one line per scene (PASS or FAIL and its numbers) and exits non-zero on a FAIL.
Imports nothing of JAX: ``parity/oracles.py`` and ``run_parity.scalar_reference`` are
numpy alone.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from parity import run_parity as rp  # noqa: E402  (numpy only at import)
from parity.oracles import pendulum_oracle, sliding_sphere_oracle  # noqa: E402

DT, RADIUS = rp.DT, rp.RADIUS


def _config(**kw):
    """``run_parity._tiny_config`` in the port."""
    from bepuphysics2_tpu_torch import SimConfig

    return SimConfig(**{**dict(body_capacity=8, max_pairs=16, substeps=rp.SUBSTEPS,
                               num_colors=2, enable_sleep=False), **kw})


def sphere_drop(device, steps):
    """``run_parity.engine_trajectory``: (y, vy) per step."""
    from bepuphysics2_tpu_torch import (BodyDescription, Box, SimConfig, Simulation, Sphere,
                                        StaticDescription)

    sim = Simulation(SimConfig(body_capacity=8, max_pairs=8, substeps=rp.SUBSTEPS,
                               num_colors=2, enable_sleep=False), device=device)
    ground = sim.add_shape(Box(50.0, 0.5, 50.0))
    sim.add_static(StaticDescription(position=(0.0, -0.5, 0.0), shape=ground))
    s = Sphere(RADIUS)
    ball = sim.add_body(BodyDescription.dynamic((0.0, rp.DROP_Y, 0.0), sim.add_shape(s), 1.0, s))
    ys, vs = np.zeros(steps), np.zeros(steps)
    for i in range(steps):
        sim.timestep(DT)
        pos, _, vel, _ = sim.get_body(ball)
        ys[i], vs[i] = pos[1], vel[1]
    return ys, vs


def sliding_sphere(device, steps, v0x, spin0y, mu):
    """``run_parity.sliding_sphere_scene``: (pos, vel, omega) per step."""
    from bepuphysics2_tpu_torch import BodyDescription, Box, Simulation, Sphere, StaticDescription

    sim = Simulation(_config(), device=device)
    ground = sim.add_shape(Box(200.0, 0.5, 200.0))
    sim.add_static(StaticDescription(position=(0.0, -0.5, 0.0), shape=ground, friction=mu))
    s = Sphere(RADIUS)
    ball = sim.add_body(BodyDescription.dynamic(
        (0.0, RADIUS, 0.0), sim.add_shape(s), 1.0, s, velocity=(v0x, 0.0, 0.0),
        angular_velocity=(0.0, spin0y, 0.0), friction=mu))
    ps, vs, ws = np.zeros((steps, 3)), np.zeros((steps, 3)), np.zeros((steps, 3))
    for i in range(steps):
        sim.timestep(DT)
        pos, _, vel, omg = sim.get_body(ball)
        ps[i], vs[i], ws[i] = pos, vel, omg
    return ps, vs, ws


def pendulum(device, steps, length=1.0, radius=0.2):
    """``run_parity.pendulum_scene``: (pos, vel) of the bob per step."""
    from bepuphysics2_tpu_torch import BodyDescription, Simulation, Sphere

    sim = Simulation(_config(joint_capacity=4), device=device)
    s = Sphere(radius)
    anchor = sim.add_body(BodyDescription.kinematic((0.0, 0.0, 0.0)))
    bob = sim.add_body(BodyDescription.dynamic((length, 0.0, 0.0), sim.add_shape(s), 1.0, s,
                                               collision_group=1))
    sim.add_constraint("ball_socket", [anchor, bob], local_offset_a=(0.0, 0.0, 0.0),
                       local_offset_b=(-length, 0.0, 0.0))
    ps, vs = np.zeros((steps, 3)), np.zeros((steps, 3))
    for i in range(steps):
        sim.timestep(DT)
        pos, _, vel, _ = sim.get_body(bob)
        ps[i], vs[i] = pos, vel
    return ps, vs


def box_stack(device, force, steps=400, mu=0.5, settle=120):
    """``run_parity.box_stack_friction_scene``: the top box's and the bottom box's moves
    and the top box's acceleration under ``force``."""
    from bepuphysics2_tpu_torch import BodyDescription, Box, Simulation, StaticDescription

    sim = Simulation(_config(substeps=8, max_pairs=32), device=device)
    ground = sim.add_shape(Box(50.0, 0.5, 50.0))
    sim.add_static(StaticDescription(position=(0.0, -0.5, 0.0), shape=ground, friction=mu))
    b = Box(1.0, 1.0, 1.0)
    bs = sim.add_shape(b)
    bot = sim.add_body(BodyDescription.dynamic((0.0, 0.5, 0.0), bs, 1.0, b, friction=mu))
    top = sim.add_body(BodyDescription.dynamic((0.0, 1.5, 0.0), bs, 1.0, b, friction=mu))
    for _ in range(settle):
        sim.timestep(DT)
    p0_top, p0_bot = sim.get_body(top)[0], sim.get_body(bot)[0]
    vxs = np.zeros(steps)
    for i in range(steps):
        _, _, vel, omg = sim.get_body(top)
        sim.set_velocity(top, (vel[0] + force * DT, vel[1], vel[2]), omg)
        sim.timestep(DT)
        vxs[i] = sim.get_body(top)[2][0]
    p1_top, p1_bot = sim.get_body(top)[0], sim.get_body(bot)[0]
    half = steps // 2
    return dict(top_disp=float(p1_top[0] - p0_top[0]), bot_disp=float(abs(p1_bot[0] - p0_bot[0])),
                accel=float((vxs[-1] - vxs[half]) / ((steps - 1 - half) * DT)),
                final_vx=float(vxs[-1]))


def hinge_chain(device, steps, n_links=3, length=0.8, radius=0.15):
    """``run_parity.hinge_chain_scene``: capsule links hinged about world z from a
    kinematic anchor, starting horizontal. Per step the chain's energy (linear kinetic and
    potential), the largest socket drift and the largest hinge-axis error."""
    from bepuphysics2_tpu_torch import BodyDescription, Capsule, Simulation

    sim = Simulation(_config(body_capacity=8, joint_capacity=8), device=device)
    cap = Capsule(radius, length * 0.5)
    cs = sim.add_shape(cap)
    handles = [sim.add_body(BodyDescription.kinematic((0.0, 0.0, 0.0)))]
    for i in range(n_links):
        # The capsule's axis (local y) along world x: -90 degrees about z.
        q = (0.0, 0.0, -np.sqrt(0.5), np.sqrt(0.5))
        h = sim.add_body(BodyDescription.dynamic(((i + 0.5) * length, 0.0, 0.0), cs, 1.0, cap,
                                                 orientation=q, collision_group=1))
        handles.append(h)
        sim.add_constraint(
            "hinge", [handles[i], h],
            local_offset_a=(0.0, 0.0, 0.0) if i == 0 else (0.0, length * 0.5, 0.0),
            local_offset_b=(0.0, -length * 0.5, 0.0), local_hinge_axis_a=(0.0, 0.0, 1.0),
            local_hinge_axis_b=(0.0, 0.0, 1.0))
    es, drift, axis_err = np.zeros(steps), np.zeros(steps), np.zeros(steps)
    for i in range(steps):
        sim.timestep(DT)
        prev_tip = np.zeros(3)
        for h in handles[1:]:
            pos, orn, vel, _ = sim.get_body(h)
            u, w = np.asarray(orn[:3]), orn[3]

            def rot(v):
                return 2 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2 * w * np.cross(u, v)

            axis_w = rot(np.array([0.0, 0.0, 1.0]))
            cap_axis = rot(np.array([0.0, 1.0, 0.0]))
            drift[i] = max(drift[i], float(np.linalg.norm(pos - cap_axis * (length * 0.5)
                                                          - prev_tip)))
            axis_err[i] = max(axis_err[i], float(np.arccos(np.clip(axis_w[2], -1, 1))))
            prev_tip = pos + cap_axis * (length * 0.5)
            # Rotational energy left out: an underestimate keeps the no-gain check strict.
            es[i] += 0.5 * float(np.dot(vel, vel)) + 10.0 * float(pos[1])
    return es, drift, axis_err


# --- envelopes: the thresholds of run_parity.py ---------------------------------------------

def run_sphere_drop(device, steps):
    """``run_parity.main``'s sphere_drop envelope."""
    ys_ref, vs_ref = rp.scalar_reference()
    ys, vs = sphere_drop(device, steps)
    ys_ref, vs_ref = ys_ref[:steps], vs_ref[:steps]
    first_contact = int(np.argmax(ys_ref < RADIUS + 0.05))
    rest_from = min(steps - 1, first_contact + 120)
    ball_n = max(1, first_contact - 2)
    env = dict(
        ballistic_max_dev_vs_closed_form=float(np.max(np.abs(
            ys[:ball_n] - rp.closed_form_ballistic(ball_n)))),
        settling_max_dev=float(np.max(np.abs(ys[first_contact:rest_from]
                                             - ys_ref[first_contact:rest_from]))),
        rest_dev=float(np.max(np.abs(ys[rest_from:] - ys_ref[rest_from:]))),
        rest_height=float(ys[-1]), rest_height_reference=float(ys_ref[-1]),
        velocity_max_dev_after_settle=float(np.max(np.abs(vs[rest_from:] - vs_ref[rest_from:]))))
    env["pass"] = bool(env["ballistic_max_dev_vs_closed_form"] < 1e-3
                       and env["settling_max_dev"] < 0.02 and env["rest_dev"] < 5e-3
                       and env["velocity_max_dev_after_settle"] < 1e-2)
    return env


def run_sliding_sphere(device, steps):
    """``run_parity.run_sliding_sphere``'s envelope."""
    v0x, spin0y, mu = 3.0, 10.0, 0.4
    ps, vs, ws = sliding_sphere(device, steps, v0x, spin0y, mu)
    op, ov, ow = sliding_sphere_oracle(v0x, spin0y, mu, radius=RADIUS, steps=steps)
    v_roll = 5.0 / 7.0 * v0x
    env = dict(
        vx_final=float(vs[-1, 0]), vx_final_oracle=float(ov[-1, 0]),
        rolling_dev=float(abs(vs[-1, 0] - v_roll)),
        rolling_dev_oracle=float(abs(ov[-1, 0] - v_roll)),
        spin_final=float(ws[-1, 1]), spin_final_oracle=float(ow[-1, 1]),
        traj_max_dev_x=float(np.max(np.abs(ps[:, 0] - op[:, 0]))),
        vel_max_dev=float(np.max(np.abs(vs - ov))), omega_max_dev=float(np.max(np.abs(ws - ow))))
    env["pass"] = bool(env["rolling_dev"] < 0.03 * v0x and env["rolling_dev_oracle"] < 0.03 * v0x
                       and env["traj_max_dev_x"] < 0.15 and env["vel_max_dev"] < 0.1
                       and env["omega_max_dev"] < 0.1 and env["spin_final"] <= 1.01 * spin0y
                       and env["spin_final"] > -0.05 * spin0y)
    return env


def run_pendulum(device, steps):
    """``run_parity.run_pendulum``'s envelope."""
    length = 1.0
    ps, vs = pendulum(device, steps, length=length)
    op, _ = pendulum_oracle(length=length, radius=0.2, steps=steps)
    rod = np.linalg.norm(ps, axis=1)
    energy = 0.5 * np.sum(vs * vs, axis=1) + 10.0 * ps[:, 1]  # starts at rest at y = 0
    first = min(300, steps)
    env = dict(
        traj_max_dev=float(np.max(np.linalg.norm(ps - op, axis=1))),
        traj_max_dev_first_300=float(np.max(np.linalg.norm(ps[:first] - op[:first], axis=1))),
        rod_length_max_err=float(np.max(np.abs(rod - length))),
        energy_max_gain=float(np.max(energy)),
        lowest_point=float(np.min(ps[:, 1])), lowest_point_oracle=float(np.min(op[:, 1])))
    env["pass"] = bool(env["traj_max_dev_first_300"] < 0.05
                       and env["rod_length_max_err"] < 0.05 * length
                       and env["energy_max_gain"] < 0.5
                       and abs(env["lowest_point"] - env["lowest_point_oracle"]) < 0.05)
    return env


def run_box_stack(device, steps=300):
    """``run_parity.run_box_stack``'s envelope: the reference's manifold friction law,
    capacity (mu/4)·m·g."""
    mu, m, g = 0.5, 1.0, 10.0
    cap = mu * m * g / 4.0
    low = box_stack(device, 0.5 * cap, steps=steps, mu=mu)
    high = box_stack(device, 4.0 * cap, steps=steps, mu=mu)
    a_expect = (4.0 * cap - cap) / m
    env = dict(static_top_disp=low["top_disp"], static_bot_disp=low["bot_disp"],
               kinetic_accel=high["accel"], kinetic_accel_closed_form=a_expect,
               kinetic_bot_disp=high["bot_disp"])
    env["pass"] = bool(abs(low["top_disp"]) < 0.05 and low["bot_disp"] < 0.05
                       and abs(high["accel"] - a_expect) < 0.25 * a_expect
                       and high["bot_disp"] < 0.08)
    return env


def run_hinge_chain(device, steps):
    """``run_parity.run_hinge_chain``'s envelope."""
    es, drift, axis_err = hinge_chain(device, steps)
    env = dict(energy_max=float(np.max(es)), energy_initial=float(es[0]),
               energy_final=float(es[-1]), socket_drift_max=float(np.max(drift)),
               hinge_axis_err_max_rad=float(np.max(axis_err)))
    env["pass"] = bool(env["energy_max"] <= env["energy_initial"] + 0.5
                       and env["socket_drift_max"] < 0.08
                       and env["hinge_axis_err_max_rad"] < 0.05)
    return env


SCENES = {"sphere_drop": run_sphere_drop, "sliding_sphere": run_sliding_sphere,
          "pendulum_ball_socket": run_pendulum, "box_stack_friction": run_box_stack,
          "hinge_chain": run_hinge_chain}


def run(name, device="cpu", steps=rp.STEPS):
    """One scene's envelope (a dict with ``pass``); the box stack keeps its own 300 pushed
    steps after 120 settling ones. On the CPU the scenes' few-element ops run on one
    thread (about twice as fast as on a pool for bodies this few); the thread count is
    restored after."""
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        return (SCENES[name](device) if name == "box_stack_friction"
                else SCENES[name](device, steps))
    finally:
        torch.set_num_threads(threads)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int, default=rp.STEPS)
    args = ap.parse_args()
    ok = True
    for name in SCENES:
        env = run(name, args.device, args.steps)
        ok &= env["pass"]
        print(f"{name}: {'PASS' if env['pass'] else 'FAIL'} {json.dumps(env)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
