"""Simulation observability metrics: energy, momentum, contact health; and a trace session.

Counterpart of ``bepuphysics2_tpu/metrics.py``. The reference exposes runtime health
through invasive hash diagnostics and its per-stage profiler (SimulationProfiler.cs:10,
Demos/SimulationTimeSamples.cs), and its demos track energy drift by summing body state.
Here every field is a reduction over the device state, computed on the state's device
with no host sync: ``float(...)`` a field to read it.

Uses: thresholds in tests (a resting pile's energy must not grow), drift dashboards for
long runs, and capacity tuning (record utilization beside ``StepDiagnostics``' overflow).
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import torch

from .bodies import BodyState, KIND_DYNAMIC


class SimMetrics(NamedTuple):
    """Scalars (0-dim tensors, (3,) for the momenta) on the state's device."""

    kinetic_energy: torch.Tensor  # sum of (m v² + ω·Iω)/2 over awake dynamics
    potential_energy: torch.Tensor  # sum of m (-g·p) over awake dynamics (0 where m = 0)
    linear_momentum: torch.Tensor  # (3,) sum of m v
    angular_momentum_origin: torch.Tensor  # (3,) sum of p x m v + Iω about the origin
    max_speed: torch.Tensor  # max |v| over awake dynamics
    max_angular_speed: torch.Tensor  # max |ω|
    max_penetration: torch.Tensor  # the JAX package's field (see compute_metrics)
    contact_impulse_total: torch.Tensor  # sum of accumulated normal impulses (solver load)
    awake_dynamic_count: torch.Tensor  # int32
    sleeping_count: torch.Tensor  # int32 sleeping dynamics (statics are never awake)
    contact_count: torch.Tensor  # int32 live contact points
    pair_utilization: torch.Tensor  # live records / record capacity (capacity tuning)


def _body_terms(state: BodyState, gravity):
    dyn = (state.kind == KIND_DYNAMIC) & state.awake
    m = torch.where(dyn & (state.inv_mass > 0), 1.0 / state.inv_mass.clamp_min(1e-30), 0.0)
    v2 = state.vel.dot(state.vel)
    # World inertia applied to ω: the closed-form inverse of the world inverse inertia.
    inertia = state.world_inv_inertia().inverse(eps=1e-30)
    l_ang = inertia.transform(state.omega)  # Iω
    rot_ke = 0.5 * state.omega.dot(l_ang)
    zero = torch.zeros_like(v2)
    ke = torch.where(dyn, 0.5 * m * v2 + rot_ke, zero).sum()
    g = [float(c) for c in gravity]
    p_dot_g = state.pos.x * g[0] + state.pos.y * g[1] + state.pos.z * g[2]
    pe = torch.where(dyn, -m * p_dot_g, zero).sum()
    mv = torch.stack([torch.where(dyn, m * c, zero).sum() for c in state.vel])
    # p x m v + Iω
    cx = state.pos.y * m * state.vel.z - state.pos.z * m * state.vel.y
    cy = state.pos.z * m * state.vel.x - state.pos.x * m * state.vel.z
    cz = state.pos.x * m * state.vel.y - state.pos.y * m * state.vel.x
    lm = torch.stack([torch.where(dyn, c + l, zero).sum() for c, l in zip((cx, cy, cz), l_ang)])
    speed = torch.sqrt(v2.clamp_min(0.0))
    wspeed = torch.sqrt(state.omega.dot(state.omega).clamp_min(0.0))
    return dyn, ke, pe, mv, lm, speed, wspeed


def compute_metrics(state, shapes, config) -> SimMetrics:
    """Reduce a SimState to SimMetrics on its device (``shapes`` is unused, as in the JAX
    package's signature). Records count from every convex and compound cache and the pair
    store. On the store path the JAX state carries two empty legacy convex caches
    (``cache`` and ``sleep_cache``, ``max_pairs`` rows each) where the port's are None:
    their capacity still counts in ``pair_utilization``, and ``max_penetration`` reads the
    first of them, so on that path it is 0 in both packages."""
    bodies = state.bodies
    dyn, ke, pe, mv, lm, speed, wspeed = _body_terms(bodies, config.integrator.gravity)
    dev = bodies.kind.device
    caches = [c for c in (state.cache, state.ccache, state.sleep_cache, state.sleep_ccache)
              if c is not None]
    imp_total = sum(torch.where(c.valid[:, None], c.penetration, 0.0).sum() for c in caches)
    n_contacts = sum((c.valid[:, None] & (c.feature >= 0) & (c.penetration != 0.0))
                     .sum().to(torch.int32) for c in caches)
    util_live = sum(c.valid.sum().to(torch.int32) for c in caches)
    util_cap = sum(c.valid.shape[0] for c in caches)
    max_pen = torch.zeros((), dtype=torch.float32, device=dev)
    if state.cache is not None:
        c = state.cache
        max_pen = torch.where(c.valid[:, None], c.penetration.abs(), 0.0).max()
    st = state.store
    if st is not None:
        if state.cache is None:
            util_cap = util_cap + 2 * config.max_pairs
        imp_total = imp_total + torch.where(st.live[:, None], st.imp_pen, 0.0).sum()
        n_contacts = n_contacts + (st.live[:, None] & (st.feature >= 0)
                                   & (st.imp_pen != 0.0)).sum().to(torch.int32)
        util_live = util_live + st.live.sum().to(torch.int32)
        util_cap = util_cap + st.live.shape[0]
    zero = torch.zeros_like(speed)
    return SimMetrics(
        kinetic_energy=ke,
        potential_energy=pe,
        linear_momentum=mv,
        angular_momentum_origin=lm,
        max_speed=torch.where(dyn, speed, zero).max(),
        max_angular_speed=torch.where(dyn, wspeed, zero).max(),
        max_penetration=max_pen,
        contact_impulse_total=imp_total,
        awake_dynamic_count=dyn.sum().to(torch.int32),
        sleeping_count=((bodies.kind == KIND_DYNAMIC) & ~bodies.awake).sum().to(torch.int32),
        contact_count=n_contacts,
        pair_utilization=util_live.to(torch.float32) / float(util_cap),
    )


def simulation_metrics(sim) -> SimMetrics:
    """``metrics = simulation_metrics(sim)``: the metrics of the simulation's current
    state, on its device (no host sync)."""
    if sim._dirty:
        sim._push()
    return compute_metrics(sim._state, sim.shapes.device(sim.device), sim.config)


class TraceSession:
    """``torch.profiler`` over a block, the counterpart of the JAX package's
    ``jax.profiler`` session (the reference's invasive tracing). Writes a Chrome trace
    (``chrome://tracing``, Perfetto) under ``log_dir``, CUDA activity included where a
    card is present:

        with TraceSession("traces"):
            sim.run(100, dt)

    ``path`` names the file after the block. Pair with ``profiling.profile_stages`` for
    per-stage times."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir,
                                 f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return False
