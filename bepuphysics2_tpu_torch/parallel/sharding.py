"""Several ranks: batched worlds and the constraint-sharded single world.

Counterpart of ``bepuphysics2_tpu/parallel/sharding.py``. The JAX package's device mesh
becomes a ``torch.distributed`` process group (``make_mesh``): one process per rank, each
with its rank, world size and rendezvous given to ``init_process_group`` by the caller
(nothing on a machine announces a cluster). NCCL serves one rank per card; ranks that
share a card, and ranks on the CPU, use gloo, whose collectives take CUDA tensors too.

1. **Batched worlds** (``batched_step_fn``): each rank steps its share of a stacked batch
   of independent worlds, one world after another, as the JAX package's ``lax.scan`` over
   each device's local worlds does. No communication.
2. **Constraint-sharded world** (``sharded_step_fn``): the bodies replicated on every
   rank, the convex cache and every joint bank sharded along their slot axis. The broad
   phase tests this rank's block of rows (``brute_force_rows``: a pair lives with its
   larger body's row, so its cache record stays on one rank), the legacy narrow phase
   carries the rank's own cache, and the solve is the masked one of
   ``solver/masked.py``: one coloring over the all-gathered constraint table, and each
   color's velocity deltas summed over the ranks with ``all_reduce``. Within a color no
   two constraints on any rank share a dynamic body, so that sum is the single-device
   Gauss-Seidel update. Sleep labels combine with ``all_reduce(MIN)``, wakes with MAX.

Both take and return this rank's view: ``replicate_state`` and ``shard_state`` make it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..collision import broadphase as bp
from ..collision.narrowphase import PairCache, narrow_phase, update_cache
from ..shapes import compute_body_bounds
from ..simulation import SimConfig, SimState, StepDiagnostics, step
from ..sleep import update_sleep, wake_touched
from ..solver.solve import solve_all
from ..utils.vec import Vec3
from . import comm


def make_mesh(n_devices: int = None, backend: str = None):
    """The process group that stands for the JAX mesh: every rank of the default group
    (``n_devices`` None or the world size, ``backend`` None), or a new group of the first
    ``n_devices`` ranks on ``backend``. Call it on every rank after
    ``torch.distributed.init_process_group``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group (its "
                           "backend, rank, world size and rendezvous) on every rank first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n == world and backend is None:
        return dist.group.WORLD
    return dist.new_group(ranks=list(range(n)), backend=backend)


def _map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf (None stays None)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(*(_map(fn, x) for x in tree))


def _stack(trees):
    """Trees of the same structure → one tree of stacked leaves."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))


def replicate_state(state: SimState, batch: int, mesh=None) -> SimState:
    """A single-world state tiled into a batch of ``batch`` worlds (a new leading axis on
    every leaf). With ``mesh``, this rank's share of it: ``batch / world size`` worlds
    (the batch must divide by the world size)."""
    if mesh is not None:
        w = comm.world_size(mesh)
        if batch % w:
            raise ValueError(f"the batch ({batch}) must divide by the mesh size ({w})")
        batch //= w
    return _map(lambda x: x.unsqueeze(0).expand((batch,) + tuple(x.shape)).clone(), state)


def batched_step_fn(config: SimConfig, mesh=None, present_types=None):
    """A step of a batch of independent worlds: ``fn(states, shapes, joint_banks, dt)``
    with every leaf of ``states`` stacked along a leading batch axis (this rank's share,
    ``replicate_state``), the shapes and joint banks shared by every world. Each world
    steps in turn through the single-world ``step``, with no communication. Returns
    (states', diagnostics stacked the same way).

    ``fn`` steps every world it is given: the split of the batch over the ranks of
    ``mesh`` is made beforehand, by ``replicate_state(state, batch, mesh)``, which
    refuses a batch that does not divide by the world size. ``mesh`` itself is accepted
    only so that the signature matches the JAX package's; the step reads nothing of it."""
    def fn(states: SimState, shapes, joint_banks, dt):
        n = states.bodies.pos.x.shape[0]
        outs, diags = [], []
        for i in range(n):
            s, d = step(_map(lambda x: x[i], states), shapes, joint_banks, dt, config,
                        present_types)
            outs.append(s)
            diags.append(d)
        return _stack(outs), _stack(diags)

    return fn


def _shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``x``'s leading axis."""
    w, r = comm.world_size(mesh), comm.rank(mesh)
    m = x.shape[0] // w
    return x[r * m:(r + 1) * m]


def shard_state(state: SimState, mesh) -> SimState:
    """This rank's view of a state for the sharded step: the bodies, the compound caches,
    the sleep banks and the store as they are (replicated), the convex cache and the joint
    impulses and colors cut to this rank's block of rows. A state without a convex cache
    (one built for the pair-store path) keeps None; the step starts it empty."""
    sh = lambda t: _map(lambda x: _shard(x, mesh), t)
    return state._replace(cache=sh(state.cache), joint_impulses=sh(state.joint_impulses),
                          joint_colors=sh(state.joint_colors))


def sharded_step_fn(config: SimConfig, mesh, present_types=None):
    """One world with its constraints sharded over the ranks of ``mesh`` (see the module
    note); JAX ``sharded_step_fn``. ``body_capacity`` and ``max_pairs`` must divide by the
    mesh size, and so must every joint bank's capacity. Returns ``make(state, shapes,
    joint_banks)``, which returns the step ``fn(state, shapes, joint_banks, dt) ->
    (state', diagnostics)``: ``state`` this rank's view (``shard_state``), ``joint_banks``
    the whole banks (each rank takes its block of rows). The diagnostics are the ranks'
    combined: pair and contact counts and the broad phase's demand summed, overflow (bit
    1, the broad phase) where any rank's broad phase overflowed."""
    n_dev = comm.world_size(mesh)
    nb = config.body_capacity
    if nb % n_dev or config.max_pairs % n_dev:
        raise ValueError(
            f"body_capacity ({nb}) and max_pairs ({config.max_pairs}) must divide by the "
            f"mesh size ({n_dev})"
        )
    rows = nb // n_dev
    local_pairs = config.max_pairs // n_dev
    scfg = config.solve_config()

    def _local_step(state: SimState, shapes, joint_banks, dt):
        dt = float(np.float32(dt))
        bodies = state.bodies
        dev = bodies.kind.device
        aabb_min, aabb_max = compute_body_bounds(
            bodies.pos, bodies.orn, bodies.vel, bodies.omega, bodies.shape, shapes, dt,
            present_types=present_types)
        has_shape = bodies.shape >= 0
        big = 3.0e38
        aabb_min = aabb_min.where(has_shape, Vec3.full(has_shape.shape, big, big, big, device=dev))
        aabb_max = aabb_max.where(has_shape,
                                  Vec3.full(has_shape.shape, -big, -big, -big, device=dev))
        pairs = bp.brute_force_rows(aabb_min, aabb_max, bodies.kind, bodies.awake,
                                    bodies.collision_group, comm.rank(mesh) * rows, rows,
                                    local_pairs)
        cache = state.cache if state.cache is not None else PairCache.empty(local_pairs,
                                                                            device=dev)
        prestep, imp, pcolor, _ = narrow_phase(bodies, shapes, pairs, cache, dt,
                                               present_types=present_types)
        if config.enable_sleep:
            bodies = wake_touched(bodies, prestep, group=mesh)
        banks = {name: dict({k: _shard(v, mesh) for k, v in joint_banks[name].items()},
                            impulse=state.joint_impulses[name], color=state.joint_colors[name])
                 for name in joint_banks}
        new_bodies, imps, joint_imps, _, ccolors, jcolors, _ = solve_all(
            bodies, [(prestep, imp, pcolor)], banks, config.integrator, scfg, dt, group=mesh)
        if config.enable_sleep:
            new_bodies = update_sleep(new_bodies, [prestep], banks, dt, config.sleep_time,
                                      group=mesh)
        cache = update_cache(prestep, imps[0], nb, ccolors[0], slot_live=pairs.valid)
        # One all_reduce(MAX) of each rank's flag: bit 1 where any broad phase overflowed.
        ovf = comm.pmax(pairs.overflow.to(torch.int32).reshape(1), mesh)[0] > 0
        counts = comm.psum(torch.cat([
            pairs.valid.sum().to(torch.int32).reshape(1),
            (prestep.contact_mask & prestep.valid[:, None]).sum().to(torch.int32).reshape(1),
            pairs.demand.to(torch.int32)]), mesh)
        diag = StepDiagnostics(
            pair_count=counts[0], contact_count=counts[1], overflow=ovf,
            overflow_src=torch.where(ovf, 1, 0).to(torch.int32),
            demand=torch.cat([counts[2:], torch.zeros(6, dtype=torch.int32, device=dev)]))
        return state._replace(bodies=new_bodies, cache=cache, joint_impulses=joint_imps,
                              joint_colors=jcolors), diag

    def make(state: SimState, shapes, joint_banks):
        """The step for this scene's joint banks (their capacities must divide by the mesh
        size, as the JAX package's ``shard_map`` requires)."""
        for name, bank in joint_banks.items():
            m = bank["bodies"].shape[0]
            if m % n_dev:
                raise ValueError(f"joint bank {name!r} ({m} rows) must divide by the mesh "
                                 f"size ({n_dev})")
        return _local_step

    return make
