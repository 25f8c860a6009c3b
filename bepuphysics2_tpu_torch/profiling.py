"""Per-stage profiling, the reference SimulationProfiler's counterpart (SimulationProfiler.cs:10,
the stage taxonomy of DefaultTimestepper.cs:28).

Counterpart of ``bepuphysics2_tpu/profiling.py`` ``profile_stages``, with its keys and
stages: bounds, broad phase, narrow phase and solve, each run on its own from the
simulation's current state as one step runs it (``simulation._step_impl``: the narrow
phase is the pair store's update and its narrow phase, or on the legacy path the
per-frame records and their cache join, with the compound bank where compounds or meshes
are present; the solve takes every bank of the step). Each stage is
timed over ``iters`` calls after one warm-up call: with CUDA events on the card (the
device's time for the stage), with the host clock on the CPU. For tuning, not for the hot
path: it syncs with the device per stage.
"""
from __future__ import annotations

import time

import torch


def _timer(device):
    """(start, stop) returning seconds between them: CUDA events on a card, else the host
    clock."""
    if device.type == "cuda":
        def start():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def stop(ev):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return ev.elapsed_time(end) / 1e3

        return start, stop
    return time.perf_counter, lambda t0: time.perf_counter() - t0


def profile_stages(sim, dt: float = 1.0 / 60.0, iters: int = 20) -> dict:
    """Returns {stage: seconds per call} measured on the simulation's current state:
    ``bounds``, ``broadphase``, ``narrowphase``, ``solve``."""
    import numpy as np

    from .collision import pairstore
    from .collision.narrowphase import narrow_phase, narrow_phase_compound, narrow_phase_store
    from .shapes import compute_body_bounds
    from .shapes.registry import COMPOUND, MESH
    from .simulation import _broadphase_method, broad_phase
    from .solver.solve import solve_all
    from .utils.vec import Vec3

    if sim._dirty:
        sim._push()
    state = sim._state
    shapes = sim.shapes.device(sim.device)
    config = sim.config
    bodies = state.bodies
    present = sim._present_types()
    dt = float(np.float32(dt))
    dev = bodies.kind.device
    start, stop = _timer(dev)

    def timeit(fn, *args):
        out = fn(*args)
        t0 = start()
        for _ in range(iters):
            out = fn(*args)
        return stop(t0) / iters, out

    def stage_bounds(b):
        amin, amax = compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, dt,
                                         spec_min=b.spec_margin_min, present_types=present)
        # Bodies without a shape are left out, as the step does.
        has_shape = b.shape >= 0
        big = 3.0e38
        return (amin.where(has_shape, Vec3.full(has_shape.shape, big, big, big, device=dev)),
                amax.where(has_shape, Vec3.full(has_shape.shape, -big, -big, -big, device=dev)))

    def stage_broad(amin, amax, b):
        return broad_phase(amin, amax, b, config)

    has_compounds = COMPOUND in present or MESH in present

    def stage_narrow(amin, amax, b, pairs):
        comp = None
        if has_compounds:
            comp = narrow_phase_compound(
                b, shapes, pairs, state.ccache, dt, config.max_compound_pairs,
                config.children_per_pair, config.child_window, present_types=present,
                max_cc_pairs=config.max_cc_pairs,
                cc_children_per_side=config.cc_children_per_side,
                meshes_meet=sim._mesh_bodies() > 1)
        if not config.use_pair_store:
            prestep, imp, pcolor, _ = narrow_phase(
                b, shapes, pairs, state.cache, dt, present_types=present,
                pairs_sorted=_broadphase_method(config) == "brute",
                sleep_bank=state.sleep_cache if config.enable_sleep else None)
            return None, pcolor, prestep, imp, comp
        sa = b.shape[pairs.a.long()]
        sb = b.shape[pairs.b.long()]
        ta = torch.where(sa >= 0, shapes.type[sa.clamp_min(0).long()], -1)
        tb = torch.where(sb >= 0, shapes.type[sb.clamp_min(0).long()], -1)
        from .collision.narrowphase import convex_type_mask
        from .shapes.custom import is_custom

        customs = [t for t in present if is_custom(t)]
        insertable = convex_type_mask(ta, customs) & convex_type_mask(tb, customs)
        ext_used = torch.zeros(config.body_capacity + 1, dtype=torch.int32, device=dev)
        churn_cap, dead_cap, repair_cap = config.store_caps()
        store, _, _, active = pairstore.update(
            state.store, b.kind, b.awake, b.collision_group, amin, amax, pairs.a, pairs.b,
            pairs.valid, insertable, config.num_colors, ext_used, churn_cap, dead_cap,
            repair_cap)
        prestep, imp, _ = narrow_phase_store(b, shapes, store, active, dt,
                                             present_types=present)
        return store, active, prestep, imp, comp

    joint_banks = sim._joint_banks()

    def stage_solve(b, narrow):
        # The store path's (store, active rows); the legacy path's (None, carried colors).
        store, active, prestep, imp, comp = narrow
        banks = {name: dict(joint_banks[name], impulse=state.joint_impulses[name],
                            color=state.joint_colors[name]) for name in joint_banks}
        contact_banks = [comp[:3]] if comp is not None else []
        if store is None:
            return solve_all(b, [(prestep, imp, active)] + contact_banks, banks,
                             config.integrator, config.solve_config(), dt)
        return solve_all(b, contact_banks, banks, config.integrator, config.solve_config(),
                         dt, store_bank=dict(store=store, ps=prestep, imp=imp, active=active),
                         base_used=store.used)

    results = {}
    results["bounds"], (amin, amax) = timeit(stage_bounds, bodies)
    results["broadphase"], pairs = timeit(stage_broad, amin, amax, bodies)
    results["narrowphase"], narrow = timeit(stage_narrow, amin, amax, bodies, pairs)
    results["solve"], _ = timeit(stage_solve, bodies, narrow)
    return results
