"""Simulation facade — construction, body/static management, and the timestep.

Counterpart of ``bepuphysics2_tpu/simulation.py`` (reference Simulation.cs:106 Create,
Simulation.cs:316 Timestep). One step is, in order:

    bounds → brute-force broad phase → pair store update → narrow phase (+ warm-start
    carry) → wake → substepped TGS solve (kernel K1) → island sleep

Topology mutation (add/remove bodies, statics, shapes) happens host-side between steps and
marks the device state dirty; the next timestep pushes the merged state. The port carries
the pair-store path for sphere and box scenes up to 8,192 bodies; a configuration or scene
that needs anything else is refused with the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .bodies import BodyBuffer, BodyDescription, BodyState, StaticDescription
from .collision import broadphase as bp
from .collision import pairstore
from .collision.narrowphase import narrow_phase_store
from .collision.pairstore import PairStore
from .integrator import IntegratorConfig
from .shapes import ShapeRegistry, compute_body_bounds
from .shapes.registry import CONVEX_HULL
from .sleep import update_sleep, wake_touched
from .solver.solve import SolveConfig, solve_all
from .utils.vec import Vec3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration; the same fields as the JAX package's SimConfig, so configs
    carry across unchanged. Fields of paths the port does not have yet must keep their
    defaults (see ``_check_supported``)."""

    body_capacity: int = 1024
    max_pairs: int = 4096
    shape_capacity: int = 256
    substeps: int = 8
    velocity_iterations: int = 1
    num_colors: int = 8
    color_cap_factor: float = 1.5
    jacobi_cap_factor: float = 0.3
    color_rounds: int = 3
    broadphase: str = "auto"  # 'brute' | 'sweep' | 'grid' | 'grid2' | 'auto'
    joint_capacity: int = 256
    max_compound_pairs: int = 256
    children_per_pair: int = 8
    child_window: int = 128
    max_cc_pairs: int = 0
    cc_children_per_side: int = 4
    sweep_window: int = 64
    grid_cell_size: float = 0.0
    grid_cell_capacity: int = 16
    grid_max_large: int = 256
    grid_entry_factor: int = 7
    grid_cell_factor: float = 1.2
    grid_pair_k: int = 8
    integrator: IntegratorConfig = IntegratorConfig()
    enable_sleep: bool = True
    sleep_time: float = 0.75
    max_ccd_pairs: int = 0
    solver_backend: str = "auto"
    use_pair_store: bool = True
    store_page: int = 0
    store_churn: int = 0
    store_dead: int = 0
    store_repair: int = 0
    wide_cap_rows: int = 0

    def store_layout(self):
        """(capacity, page) for the pair store — capacity = max_pairs rounded to pages."""
        page = self.store_page
        if page == 0:
            page = 512 if self.max_pairs >= 8192 else (128 if self.max_pairs >= 1024 else 32)
        cap = -(-self.max_pairs // page) * page
        return cap, page

    def store_caps(self):
        cap, _ = self.store_layout()
        churn = self.store_churn or max(128, cap // 8)
        dead = self.store_dead or max(128, cap // 8)
        repair = self.store_repair or max(64, cap // 16)
        return churn, dead, repair

    def solve_config(self) -> SolveConfig:
        return SolveConfig(
            substeps=self.substeps,
            velocity_iterations=self.velocity_iterations,
            num_colors=self.num_colors,
            color_cap_factor=self.color_cap_factor,
            jacobi_cap_factor=self.jacobi_cap_factor,
            color_rounds=self.color_rounds,
            backend=self.solver_backend,
            wide_cap_rows=self.wide_cap_rows,
        )


class SimState(NamedTuple):
    """Device-side state of the store path: bodies and the persistent pair store."""

    bodies: BodyState
    store: PairStore


class StepDiagnostics(NamedTuple):
    pair_count: torch.Tensor
    contact_count: torch.Tensor
    overflow: torch.Tensor
    # Which capacity tripped (bitmask): 1=broad phase, 2=solver buckets, 4=pair store.
    overflow_src: torch.Tensor = 0
    # (12,) int32 true demand counters:
    # [0 broad-phase candidate pairs, 1 grid entries, 2 grid large set,
    #  3 store admissions this frame, 4 store live rows, 5 solver Jacobi rows,
    #  6 windowed wide rows, 7 store retirements, 8 max per-row candidates,
    #  9 grid cell-window overflow flag, 10 grid per-row-k overflow flag, 11 reserved].
    demand: torch.Tensor = None


(D_PAIRS, D_ENTRIES, D_LARGE, D_ADMIT, D_LIVE, D_JACOBI, D_WIDE, D_DEAD,
 D_MAXROW, D_WINHIT, D_ROWKHIT, _D_RSVD) = range(12)
DEMAND_LEN = 12


def _check_supported(config: SimConfig, present_types) -> None:
    """Refuse, before stepping, a configuration that needs a path the port lacks."""
    if not config.use_pair_store:
        raise NotImplementedError("the legacy per-frame cache path is not ported")
    method = config.broadphase
    if method == "auto":
        method = "brute" if config.body_capacity <= 8192 else "grid2"
    if method != "brute":
        raise NotImplementedError(
            f"broad phase {method!r} is not ported yet (ROADMAP queue 1 item 12)")
    if config.max_ccd_pairs > 0:
        raise NotImplementedError("CCD is not ported yet (ROADMAP queue 1 item 19)")
    if config.solver_backend == "pallas_win":
        raise NotImplementedError("the windowed solve (K2) is not ported yet (ROADMAP queue 2)")
    if present_types is not None and any(t > CONVEX_HULL for t in present_types):
        raise NotImplementedError("compounds and meshes are not ported yet (ROADMAP queue 1 item 18)")


def _step_impl(state: SimState, shapes, joint_banks, dt, config: SimConfig, present_types=None):
    """One full timestep: (state, shapes, joints, dt) → (state', diagnostics)."""
    _check_supported(config, present_types)
    if joint_banks:
        raise NotImplementedError("joints are not ported yet (ROADMAP queue 1 items 15-16)")
    dt = float(np.float32(dt))  # the JAX step takes dt as float32
    bodies = state.bodies
    dev = bodies.kind.device

    # --- Predict bounding boxes (speculative AABBs); no collidable, no overlap.
    aabb_min, aabb_max = compute_body_bounds(
        bodies.pos, bodies.orn, bodies.vel, bodies.omega, bodies.shape, shapes, dt,
        spec_min=bodies.spec_margin_min,
    )
    has_shape = bodies.shape >= 0
    big = 3.0e38
    aabb_min = aabb_min.where(has_shape, Vec3.full(has_shape.shape, big, big, big, device=dev))
    aabb_max = aabb_max.where(has_shape, Vec3.full(has_shape.shape, -big, -big, -big, device=dev))

    # --- Broad phase.
    pairs = bp.brute_force(aabb_min, aabb_max, bodies.kind, bodies.awake,
                           bodies.collision_group, config.max_pairs)

    # --- Pair store + narrow phase. Only convex-capable pairs live in the store.
    def _shape_type(body):
        s = bodies.shape[body.long()]
        return torch.where(s >= 0, shapes.type[s.clamp_min(0).long()], -1)

    ta_, tb_ = _shape_type(pairs.a), _shape_type(pairs.b)
    insertable = (ta_ >= 0) & (ta_ <= CONVEX_HULL) & (tb_ >= 0) & (tb_ <= CONVEX_HULL)
    # No joint or compound bank holds color claims in the scenes the port carries.
    ext_used = torch.zeros(config.body_capacity + 1, dtype=torch.int32, device=dev)
    churn_cap, dead_cap, repair_cap = config.store_caps()
    store, sovfl, store_demand, active = pairstore.update(
        state.store, bodies.kind, bodies.awake, bodies.collision_group,
        aabb_min, aabb_max, pairs.a, pairs.b, pairs.valid, insertable,
        config.num_colors, ext_used, churn_cap, dead_cap, repair_cap,
    )
    prestep, imp, _ = narrow_phase_store(bodies, shapes, store, active, dt,
                                         present_types=present_types)

    # --- Wake sleeping bodies touched by awake dynamics (whole stored islands).
    if config.enable_sleep:
        bodies = wake_touched(bodies, prestep)

    # --- Solve (substepped TGS; includes all pose/velocity integration).
    store_bank = dict(store=store, ps=prestep, imp=imp, active=active)
    bodies, imps, _, solver_overflow, _, _, solver_demand = solve_all(
        bodies, [], {}, config.integrator, config.solve_config(), dt,
        store_bank=store_bank, base_used=store.used,
    )
    # Impulses return in slot order and persist only for rows that solved this frame;
    # sleeping rows keep their banked impulses and features.
    imp_slot = imps[0]
    sleeping_row = store.live & ~active
    a1 = active[:, None]
    store = store._replace(
        imp_pen=torch.where(a1, imp_slot.penetration, store.imp_pen),
        imp_tx=torch.where(active, imp_slot.tangent.x, store.imp_tx),
        imp_ty=torch.where(active, imp_slot.tangent.y, store.imp_ty),
        imp_tw=torch.where(active, imp_slot.twist, store.imp_tw),
        feature=torch.where(
            prestep.valid[:, None], prestep.feature,
            torch.where(sleeping_row[:, None], store.feature, -1),
        ),
        active_prev=torch.where(active, prestep.valid, store.active_prev),
    )

    # --- Island sleeping.
    if config.enable_sleep:
        bodies = update_sleep(bodies, [prestep], {}, dt, config.sleep_time)

    def _src(flag, bit):
        return torch.where(flag, bit, 0).to(torch.int32)

    overflow = pairs.overflow | solver_overflow | sovfl
    ovfl_src = _src(pairs.overflow, 1) | _src(solver_overflow, 2) | _src(sovfl, 4)
    contact_count = (prestep.contact_mask & prestep.valid[:, None]).sum().to(torch.int32)
    bd = pairs.demand
    diag = StepDiagnostics(
        pair_count=store.live.sum().to(torch.int32),
        contact_count=contact_count,
        overflow=overflow,
        overflow_src=ovfl_src,
        demand=torch.cat([
            bd[:3], store_demand[0:1], store_demand[2:3], solver_demand,
            store_demand[1:2], bd[3:6], torch.zeros(1, dtype=torch.int32, device=dev),
        ]),
    )
    return SimState(bodies, store), diag


step = _step_impl


def _leaves(tree):
    """Tensor leaves of a NamedTuple tree, in field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for x in tree:
            yield from _leaves(x)


class Simulation:
    """Host-side facade (reference Simulation.Create; Simulation.cs:106). ``device``
    places the state and every step on that torch device."""

    def __init__(self, config: SimConfig = SimConfig(), device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.shapes = ShapeRegistry(config.shape_capacity)
        self._host = BodyBuffer(config.body_capacity)
        self._state: Optional[SimState] = None
        self._colors_stale = False
        self._dirty = True
        self.last_diag: Optional[StepDiagnostics] = None
        self._next_collision_group = 1

    def new_collision_group(self) -> int:
        """Fresh collision-group id: bodies sharing a nonzero group do not collide."""
        g = self._next_collision_group
        self._next_collision_group += 1
        return g

    # --- shape / body management -------------------------------------------------------
    def add_shape(self, shape) -> int:
        return self.shapes.add(shape)

    def add_body(self, desc: BodyDescription) -> int:
        self._sync_from_device()
        self._dirty = True
        return self._host.add(desc)

    def add_static(self, desc: StaticDescription) -> int:
        self._sync_from_device()
        self._dirty = True
        return self._host.add(desc)

    def remove_body(self, handle: int) -> None:
        self._sync_from_device()
        self._dirty = True
        # The slot may be recycled with a different kind → the store's colors and
        # claims (keyed by body slot) are invalid.
        self._colors_stale = True
        self._host.remove(handle)

    @property
    def body_count(self) -> int:
        return self._host.count

    # --- state access ------------------------------------------------------------------
    def _sync_from_device(self) -> None:
        if self._state is not None and not self._dirty:
            self._host.load(self._state.bodies)
            self._dirty = True  # host is now the source of truth

    def _push(self) -> None:
        cap, page = self.config.store_layout()
        store = self._state.store if self._state is not None else None
        if store is None or self._colors_stale:
            store = PairStore.empty(cap, self.config.body_capacity, page, device=self.device)
            self._colors_stale = False
        self._state = SimState(self._host.device(self.device), store)
        self._dirty = False

    @property
    def state(self) -> SimState:
        if self._dirty:
            self._push()
        return self._state

    def get_body(self, handle: int):
        """Host view of one body: (position, orientation, velocity, angular velocity)."""
        self._sync_from_device()
        h = self._host
        return (
            np.array([h.px[handle], h.py[handle], h.pz[handle]]),
            np.array([h.qx[handle], h.qy[handle], h.qz[handle], h.qw[handle]]),
            np.array([h.vx[handle], h.vy[handle], h.vz[handle]]),
            np.array([h.wx[handle], h.wy[handle], h.wz[handle]]),
        )

    def state_hash(self) -> int:
        """Deterministic hash of the full device state (reference
        InvasiveHashDiagnostics.cs:10 — cross-run divergence bisection)."""
        if self._dirty:
            self._push()
        h = hashlib.sha256()
        for leaf in _leaves(self._state):
            h.update(leaf.detach().cpu().numpy().tobytes())
        return int.from_bytes(h.digest()[:8], "little")

    # --- stepping ----------------------------------------------------------------------
    def _present_types(self):
        return tuple(sorted({int(t) for t in self.shapes.types if t >= 0}))

    def timestep(self, dt: float = 1.0 / 60.0) -> None:
        if self._dirty:
            self._push()
        self._state, self.last_diag = _step_impl(
            self._state, self.shapes.device(self.device), {}, dt, self.config,
            self._present_types(),
        )

    def run(self, steps: int, dt: float = 1.0 / 60.0, chunk: Optional[int] = None) -> None:
        """Step ``steps`` frames. ``last_diag`` then reports the run: overflow flags are
        sticky over it and demand is the peak over it (as the JAX package's scanned
        chunks report). ``chunk`` is accepted for the JAX signature; the port steps
        frame by frame."""
        overflow = src = peak = None
        for _ in range(steps):
            self.timestep(dt)
            d = self.last_diag
            overflow = d.overflow if overflow is None else overflow | d.overflow
            src = d.overflow_src if src is None else src | d.overflow_src
            peak = d.demand if peak is None else torch.maximum(peak, d.demand)
        if steps > 0:
            self.last_diag = self.last_diag._replace(overflow=overflow, overflow_src=src,
                                                     demand=peak)


# The rest of the JAX Simulation's methods, refused by name until their ROADMAP item
# lands, so that a script written for the JAX package fails with the reason.
_NOT_PORTED = {
    "reconfigure": "queue 1 item 11 (capacity management)",
    "autosize": "queue 1 item 11 (capacity management)",
    "set_pose": "queue 1 item 11 (host-side setters)",
    "set_velocity": "queue 1 item 11 (host-side setters)",
    "set_local_inertia": "queue 1 item 11 (host-side setters)",
    "set_body_kind": "queue 1 item 11 (host-side setters)",
    "wake_body": "queue 1 item 11 (host-side setters)",
    "add_constraint": "queue 1 items 15-16 (joints)",
    "remove_constraint": "queue 1 items 15-16 (joints)",
    "update_constraint": "queue 1 items 15-16 (joints)",
    "get_constraint": "queue 1 items 15-16 (joints)",
    "ray_cast": "queue 1 item 20 (queries)",
    "box_query": "queue 1 item 20 (queries)",
    "sweep": "queue 1 item 20 (queries)",
    "sweep_shape": "queue 1 item 20 (queries)",
    "sweep_shape_batch": "queue 1 item 20 (queries)",
    "contacts": "queue 1 item 20 (queries)",
    "live_contact_pairs": "queue 1 item 20 (queries)",
    "contact_events": "queue 1 item 20 (queries)",
    "save_checkpoint": "queue 1 item 21 (utilities)",
    "load_checkpoint": "queue 1 item 21 (utilities)",
}


def _refuse(name, item):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"Simulation.{name} is not ported yet (ROADMAP {item})")

    method.__name__ = name
    return method


for _name, _item in _NOT_PORTED.items():
    setattr(Simulation, _name, _refuse(_name, _item))
