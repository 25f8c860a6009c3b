"""Simulation facade — construction, body/static/constraint management, and the timestep.

Counterpart of ``bepuphysics2_tpu/simulation.py`` (reference Simulation.cs:106 Create,
Simulation.cs:316 Timestep). One step is, in order:

    bounds → broad phase (brute force, or grid2 above 8,192 bodies; ``sweep`` and ``grid``
    on request) → pair store update → narrow phase (+ warm-start carry; compound children
    keyed through their cache) → wake → substepped TGS solve (store-only scenes: kernel
    K1, or the windowed K2 above 8,192 bodies; scenes with joints: the general path over
    K3) → island sleep → compound cache and sleep-bank update

With ``use_pair_store=False`` (the legacy per-frame path) the pair store gives way to the
broad phase's candidates: their records carry last frame's impulses and colors through a
sorted join against the convex ``cache``, the general path colors and buckets them every
step (one K1 launch for a contact-only scene, K3 beside joints), and the records of
sleeping pairs move to ``sleep_cache`` and back.

Topology mutation (bodies, statics, shapes, constraints, host setters) happens host-side
between steps and marks the device state dirty; the next timestep pushes the merged state.
``reconfigure`` and ``autosize`` resize capacities between steps, migrating the pair store
and resizing the compound caches. The queries (ray casts, sweeps, the box query, contact
records and events) read the device state between steps. Every configuration the JAX
package accepts runs; the constraint-sharded step and batched worlds are in
``parallel/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .bodies import (
    BodyBuffer, BodyDescription, BodyState, KIND_DYNAMIC, KIND_EMPTY, KIND_KINEMATIC,
    StaticDescription,
    to_device,
)
from .collision import broadphase as bp
from .collision import pairstore
from .collision.narrowphase import (
    PairCache, ccd_eval_times, convex_type_mask, narrow_phase, narrow_phase_compound,
    narrow_phase_store, retain_sleeping_when, update_cache, update_cache_keyed,
)
from .collision.pairstore import PairStore
from .constraints.joints import (
    JOINT_TYPES, ONE_BODY_NAMES, JointTypeStore, make_description,
)
from .constraints.joints.base import unpack_fields
from .integrator import IntegratorConfig
from .shapes import ShapeRegistry, compute_body_bounds
from .shapes.custom import CUSTOM_SUPPORTS, is_custom
from .shapes.registry import BIG_COMPOUND, COMPOUND, CONVEX_HULL, MESH, TRIANGLE
from .sleep import update_sleep, wake_touched
from .solver.solve import SolveConfig, solve_all
from .utils.vec import Vec3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration; the same fields as the JAX package's SimConfig, so configs
    carry across unchanged. ``solver_backend="pallas_win"`` forces the windowed solve (K2)
    at any size; every other value takes K1 up to 8,192 bodies."""

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
    # The one field the JAX SimConfig lacks (there only its SolveConfig carries it): a
    # tuple of velocity iterations per substep (``SolveConfig.iteration_schedule``).
    iteration_schedule: tuple = None

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

    def compound_capacity(self) -> int:
        """Rows of the compound child caches."""
        return (self.max_compound_pairs * self.children_per_pair
                + self.max_cc_pairs * self.cc_children_per_side ** 2)

    def compound_sub_cap(self) -> int:
        """Child slots per pair in the compound cache keys (pair key x this + slot)."""
        return self.children_per_pair + (
            self.cc_children_per_side ** 2 if self.max_cc_pairs > 0 else 0)

    def solve_config(self) -> SolveConfig:
        return SolveConfig(
            substeps=self.substeps,
            velocity_iterations=self.velocity_iterations,
            num_colors=self.num_colors,
            color_cap_factor=self.color_cap_factor,
            jacobi_cap_factor=self.jacobi_cap_factor,
            color_rounds=self.color_rounds,
            iteration_schedule=self.iteration_schedule,
            backend=self.solver_backend,
            wide_cap_rows=self.wide_cap_rows,
        )


class SimState(NamedTuple):
    """Device-side state, the JAX SimState's fields in its order. The convex records live
    in the pair store, or with ``use_pair_store=False`` in the per-frame ``cache`` and its
    sleep bank; the banks of the path a configuration does not run are None (the JAX
    package carries empty convex caches beside its store, which its store path never
    reads)."""

    bodies: BodyState
    cache: Optional[PairCache]  # legacy path: convex contact records, b-major keys
    ccache: PairCache  # compound child contact records
    joint_impulses: dict  # name -> (M, N_IMPULSE)
    joint_colors: dict  # name -> (M,) int32 persisted solver colors, -1 = none
    sleep_cache: Optional[PairCache]  # legacy path: sleeping convex records
    sleep_ccache: PairCache  # sleeping compound child records
    store: Optional[PairStore] = None  # the pair store; None in a legacy configuration


class StepDiagnostics(NamedTuple):
    pair_count: torch.Tensor
    contact_count: torch.Tensor
    overflow: torch.Tensor
    # Which capacity tripped (bitmask): 1=broad phase, 2=solver buckets, 4=pair store,
    # 8=compound children, 16=sleep retention, 32=compound sleep retention.
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


def _broadphase_method(config: SimConfig) -> str:
    """The broad phase a configuration runs: ``auto`` is brute force up to 8,192 bodies and
    grid2 above; a name other than brute, grid2 and grid is the sweep, as in the JAX
    package."""
    if config.broadphase == "auto":
        return "brute" if config.body_capacity <= 8192 else "grid2"
    return config.broadphase if config.broadphase in ("brute", "grid2", "grid") else "sweep"


def broad_phase(aabb_min, aabb_max, bodies, config: SimConfig):
    """The configuration's broad phase over these bounds (JAX ``_step_impl`` :240-269)."""
    args = (aabb_min, aabb_max, bodies.kind, bodies.awake, bodies.collision_group,
            config.max_pairs)
    method = _broadphase_method(config)
    if method == "brute":
        return bp.brute_force(*args)
    if method == "grid2":
        return bp.grid2(*args, config.grid_cell_size, config.grid_cell_capacity,
                        config.grid_max_large, config.grid_entry_factor,
                        config.grid_cell_factor, config.grid_pair_k)
    if method == "grid":
        return bp.grid(*args, config.grid_cell_size, config.grid_cell_capacity,
                       config.grid_max_large)
    return bp.sweep(*args, config.sweep_window)


def _check_supported(config: SimConfig, present_types) -> None:
    """Refuse, before stepping, a scene whose shape types are unknown."""
    for t in present_types or ():
        if t > CONVEX_HULL and t not in (COMPOUND, BIG_COMPOUND, MESH) and not is_custom(t):
            raise ValueError(f"shape type {t} is neither built in nor a registered custom shape")


def _step_impl(state: SimState, shapes, joint_banks, dt, config: SimConfig, present_types=None,
               meshes_meet=True):
    """One full timestep: (state, shapes, joints, dt) → (state', diagnostics).
    ``meshes_meet`` False: at most one body is a mesh (``narrow_phase_compound``)."""
    _check_supported(config, present_types)
    dt = float(np.float32(dt))  # the JAX step takes dt as float32
    bodies = state.bodies
    dev = bodies.kind.device
    C = config.num_colors

    # --- Predict bounding boxes (speculative AABBs); no collidable, no overlap.
    aabb_min, aabb_max = compute_body_bounds(
        bodies.pos, bodies.orn, bodies.vel, bodies.omega, bodies.shape, shapes, dt,
        spec_min=bodies.spec_margin_min, present_types=present_types,
    )
    has_shape = bodies.shape >= 0
    big = 3.0e38
    aabb_min = aabb_min.where(has_shape, Vec3.full(has_shape.shape, big, big, big, device=dev))
    aabb_max = aabb_max.where(has_shape, Vec3.full(has_shape.shape, -big, -big, -big, device=dev))

    # --- Broad phase.
    pairs = broad_phase(aabb_min, aabb_max, bodies, config)
    use_store = config.use_pair_store
    nb_cap = config.body_capacity
    customs = [t for t in (CUSTOM_SUPPORTS if present_types is None else present_types)
               if is_custom(t)]
    has_compounds = present_types is None or COMPOUND in present_types or MESH in present_types

    if use_store:
        # --- Pair store + narrow phase. Only convex-capable pairs live in the store;
        # compound-endpoint pairs flow to the child expansion below.
        def _shape_type(body):
            s = bodies.shape[body.long()]
            return torch.where(s >= 0, shapes.type[s.clamp_min(0).long()], -1)

        insertable = (convex_type_mask(_shape_type(pairs.a), customs)
                      & convex_type_mask(_shape_type(pairs.b), customs))
        # Color claims held by the joint banks and the compound child records: the store
        # must not admit a pair into a (body, color) slot one of them holds.
        ext_used = torch.zeros(nb_cap + 1, dtype=torch.int32, device=dev)
        for name in joint_banks:
            bank = joint_banks[name]
            ext_used = ext_used | pairstore.store_claims(
                bank["bodies"], state.joint_colors[name], bank["valid"], nb_cap, C)
        cc = state.ccache
        ext_used = ext_used | pairstore.store_claims(
            torch.stack([cc.body_a, cc.body_b], -1), cc.color, cc.valid, nb_cap, C)
        churn_cap, dead_cap, repair_cap = config.store_caps()
        store, sovfl, store_demand, active = pairstore.update(
            state.store, bodies.kind, bodies.awake, bodies.collision_group,
            aabb_min, aabb_max, pairs.a, pairs.b, pairs.valid, insertable,
            C, ext_used, churn_cap, dead_cap, repair_cap,
        )
        prestep, imp, t_eval = narrow_phase_store(bodies, shapes, store, active, dt,
                                                  present_types=present_types,
                                                  max_ccd=config.max_ccd_pairs)
        if has_compounds and config.max_ccd_pairs > 0:
            # t_eval above is aligned with the store's slots; the compound expansion reads
            # the broad phase's candidates, so its CCD times come from a second pass over
            # them (under the max_ccd_pairs cap the two passes may keep different pairs).
            t_eval = ccd_eval_times(bodies, shapes, pairs.a, pairs.b, pairs.valid, dt,
                                    config.max_ccd_pairs, present_types)
        pcolor = None
    else:
        # --- Legacy per-frame path: every candidate's records, joined to last frame's
        # cache (presorted where the brute force emits ascending b-major keys).
        store, store_demand = None, torch.zeros(3, dtype=torch.int32, device=dev)
        prestep, imp, pcolor, t_eval = narrow_phase(
            bodies, shapes, pairs, state.cache, dt, present_types=present_types,
            max_ccd=config.max_ccd_pairs,
            pairs_sorted=_broadphase_method(config) == "brute",
            sleep_bank=state.sleep_cache if config.enable_sleep else None)
    if has_compounds:
        cprestep, cimp, cpcolor, ckey, covfl = narrow_phase_compound(
            bodies, shapes, pairs, state.ccache, dt, config.max_compound_pairs,
            config.children_per_pair, config.child_window, present_types=present_types,
            max_cc_pairs=config.max_cc_pairs, cc_children_per_side=config.cc_children_per_side,
            sleep_bank=state.sleep_ccache if config.enable_sleep else None,
            pair_t=t_eval, meshes_meet=meshes_meet,
        )

    # --- Wake sleeping bodies touched by awake dynamics (whole stored islands).
    if config.enable_sleep:
        bodies = wake_touched(bodies, prestep)
        if has_compounds:
            bodies = wake_touched(bodies, cprestep)

    # --- Solve (substepped TGS; includes all pose/velocity integration).
    banks = {name: dict(joint_banks[name], impulse=state.joint_impulses[name],
                        color=state.joint_colors[name]) for name in joint_banks}
    if use_store:
        store_bank = dict(store=store, ps=prestep, imp=imp, active=active)
        contact_banks = []
    else:
        store_bank = None
        contact_banks = [(prestep, imp, pcolor)]
    if has_compounds:
        contact_banks.append((cprestep, cimp, cpcolor))
    bodies, imps, joint_imps, solver_overflow, ccolors, jcolors, solver_demand = solve_all(
        bodies, contact_banks, banks, config.integrator, config.solve_config(), dt,
        store_bank=store_bank, base_used=store.used if use_store else None,
    )
    if use_store:
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
        sleep_presteps = [prestep] + ([cprestep] if has_compounds else [])
        bodies = update_sleep(bodies, sleep_presteps, banks, dt, config.sleep_time)

    def _src(flag, bit):
        return torch.where(flag, bit, 0).to(torch.int32)

    overflow = pairs.overflow | solver_overflow
    ovfl_src = _src(pairs.overflow, 1) | _src(solver_overflow, 2)
    if use_store:
        cache = state.cache  # not read by the store path
        overflow = overflow | sovfl
        ovfl_src = ovfl_src | _src(sovfl, 4)
    else:
        cache = update_cache(prestep, imps[0], nb_cap, ccolors[0], slot_live=pairs.valid)
    contact_count = (prestep.contact_mask & prestep.valid[:, None]).sum().to(torch.int32)
    ccache, sleep_ccache, sleep_cache = state.ccache, state.sleep_ccache, state.sleep_cache
    if has_compounds:
        ccache = update_cache_keyed(cprestep, imps[-1], ckey, ccolors[0 if use_store else 1])
        overflow = overflow | covfl
        ovfl_src = ovfl_src | _src(covfl, 8)
        contact_count = contact_count + (
            cprestep.contact_mask & cprestep.valid[:, None]).sum().to(torch.int32)
    if config.enable_sleep and (has_compounds or not use_store):
        # The JAX package merges a sleep bank only when something sleeps or the bank holds
        # rows; the port merges always and keeps the bank where that is false.
        asleep = ((bodies.kind == KIND_DYNAMIC) & ~bodies.awake).any()
        if not use_store:  # the store retains its sleeping pairs in place
            sleep_cache, rovfl = retain_sleeping_when(
                asleep | state.sleep_cache.valid.any(), state.sleep_cache, cache,
                bodies.kind, bodies.awake, nb_cap)
            overflow = overflow | rovfl
            ovfl_src = ovfl_src | _src(rovfl, 16)
        if has_compounds:
            sleep_ccache, scovfl = retain_sleeping_when(
                asleep | state.sleep_ccache.valid.any(), state.sleep_ccache, ccache,
                bodies.kind, bodies.awake, nb_cap, sub_cap=config.compound_sub_cap())
            overflow = overflow | scovfl
            ovfl_src = ovfl_src | _src(scovfl, 32)
    bd = pairs.demand
    diag = StepDiagnostics(
        pair_count=(store.live if use_store else pairs.valid).sum().to(torch.int32),
        contact_count=contact_count,
        overflow=overflow,
        overflow_src=ovfl_src,
        demand=torch.cat([
            bd[:3], store_demand[0:1], store_demand[2:3], solver_demand,
            store_demand[1:2], bd[3:6], torch.zeros(1, dtype=torch.int32, device=dev),
        ]),
    )
    return SimState(bodies, cache, ccache, joint_imps, jcolors, sleep_cache, sleep_ccache,
                    store), diag


step = _step_impl


def step_n(state: SimState, shapes, joint_banks, dt, config: SimConfig, present_types, n: int):
    """``n`` steps in one call (the JAX package scans them in one dispatch; here ``step``
    n times). Returns (state', the last step's diagnostics with ``overflow`` and
    ``overflow_src`` sticky over the n steps and ``demand`` their peak), as
    ``Simulation.run`` reports a run."""
    overflow = src = peak = None
    for _ in range(n):
        state, diag = _step_impl(state, shapes, joint_banks, dt, config, present_types)
        overflow = diag.overflow if overflow is None else overflow | diag.overflow
        src = diag.overflow_src if src is None else src | diag.overflow_src
        peak = diag.demand if peak is None else torch.maximum(peak, diag.demand)
    return state, diag._replace(overflow=overflow, overflow_src=src, demand=peak)


def _leaves(tree):
    """Tensor leaves of a NamedTuple tree, in field order (dicts in key order; a None
    field has none)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif tree is None:
        return
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        for x in tree:
            yield from _leaves(x)


class Simulation:
    """Host-side facade (reference Simulation.Create; Simulation.cs:106). ``device``
    places the state and every step on that torch device: the CUDA card unless the
    caller asks for another (``device="cpu"``). Without a card, a default simulation
    raises when it first touches the device."""

    def __init__(self, config: SimConfig = SimConfig(), device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.shapes = ShapeRegistry(config.shape_capacity)
        self._host = BodyBuffer(config.body_capacity)
        self.joints: dict = {}  # name -> JointTypeStore
        self._state: Optional[SimState] = None
        self._colors_stale = False
        self._dirty = True
        self._mirrored: Optional[SimState] = None  # the device state the host's columns hold
        self.last_diag: Optional[StepDiagnostics] = None
        self._next_collision_group = 1

    def new_collision_group(self) -> int:
        """Fresh collision-group id: bodies sharing a nonzero group do not collide."""
        g = self._next_collision_group
        self._next_collision_group += 1
        return g

    def reconfigure(self, **overrides) -> None:
        """Change the static configuration in place (reference Simulation.EnsureCapacity /
        Resize, Simulation.cs:332-415). A change of the pair store's capacity or page
        migrates the store host-side, keeping every live pair's record; the legacy convex
        caches and the compound child caches resize with their records kept.
        ``body_capacity`` is not resizable: the store's per-body tables and the cache keys
        are sized by it."""
        if "body_capacity" in overrides and overrides["body_capacity"] != self.config.body_capacity:
            raise ValueError("body_capacity is not resizable (pair keys encode it)")
        self._sync_from_device()
        self.config = dataclasses.replace(self.config, **overrides)
        cfg = self.config
        st = self._state
        if st is not None:
            cache = sleep_cache = store = None
            if cfg.use_pair_store:
                store = st.store
                cap, page = cfg.store_layout()
                if store is None:
                    store = PairStore.empty(cap, cfg.body_capacity, page, device=self.device)
                elif store.capacity != cap or store.page != page:
                    store = pairstore.migrate(store, cap, cfg.body_capacity, page,
                                              cfg.num_colors, kind=self._host.kind)
            else:
                fresh = lambda: PairCache.empty(cfg.max_pairs, device=self.device)
                cache = (st.cache or fresh()).resized(cfg.max_pairs)
                sleep_cache = (st.sleep_cache or fresh()).resized(cfg.max_pairs)
            cc_cap = cfg.compound_capacity()
            self._state = st._replace(
                cache=cache, sleep_cache=sleep_cache, store=store,
                ccache=st.ccache.resized(cc_cap), sleep_ccache=st.sleep_ccache.resized(cc_cap))
        self._dirty = True

    def autosize(self, dt: float = 1.0 / 60.0, probe_steps: int = 16,
                 headroom: float = 2.0, max_rounds: int = 3,
                 pairs_headroom: float = None) -> dict:
        """Demand-driven capacity derivation, as the JAX package's ``autosize`` does it
        (the reference sizes every structure from live counts,
        SimulationAllocationSizes.cs): probe-run the scene, read the peak demand counters
        (``StepDiagnostics.demand``) to the host, reconfigure capacities to demand ×
        ``headroom``, and repeat while an overflow bit is still set. After a change of
        ``max_pairs`` the next round first runs ``probe_steps`` to let the migrated store
        refill before it measures. Compound-child overflow (bit 8) has no demand counter
        and doubles ``max_compound_pairs``. Returns {"demand", "overflow", "rounds"}."""
        d = None
        rounds = 0
        resized_store = False
        for rounds in range(1, max_rounds + 1):
            if resized_store:
                self.run(probe_steps, dt, chunk=probe_steps)
                resized_store = False
            self.run(probe_steps, dt, chunk=probe_steps)
            diag = self.last_diag
            d = diag.demand.cpu().numpy()
            src = int(diag.overflow_src)
            n = self.config.body_capacity

            def up(x, mult=256, floor=512):
                want = int(int(x) * headroom)
                return max(floor, ((want + mult - 1) // mult) * mult)

            new = {}
            # The pair world (broad-phase candidates and store slots share max_pairs),
            # with slack for one partial color-homogeneous page per color.
            ph = pairs_headroom if pairs_headroom is not None else headroom
            pg = 512 if max(d[D_PAIRS], d[D_LIVE]) * ph >= 8192 else 128
            frag = (self.config.num_colors + 1) * pg
            want_pairs = max(1024, ((int(max(d[D_PAIRS], d[D_LIVE]) * ph) + frag + 511)
                                    // 512) * 512)
            if want_pairs != self.config.max_pairs:
                new["max_pairs"] = want_pairs
            # Store churn caps, bounded by a quarter of the pair world.
            if self.config.use_pair_store:
                bank = new.get("max_pairs", self.config.max_pairs)
                new["store_churn"] = min(up(d[D_ADMIT], 128, 256), max(256, bank // 4))
                new["store_dead"] = min(up(d[D_DEAD], 128, 256), max(256, bank // 4))
                new["store_repair"] = min(up(d[D_JACOBI], 64, 128), max(128, bank // 8))
            # Windowed wide rows (Morton-seam crossings).
            new["wide_cap_rows"] = up(d[D_WIDE], 256, 256)
            # Grid structures (only when the grid broad phase ran).
            if d[D_ENTRIES] > 0:
                new["grid_entry_factor"] = max(2, -(-int(d[D_ENTRIES] * headroom) // max(n, 1)))
            if d[D_LARGE] > 0:
                new["grid_max_large"] = up(d[D_LARGE], 64, 64)
            # Caps without a cheap exact count grow geometrically on their flags.
            if d[D_WINHIT]:
                new["grid_cell_capacity"] = 2 * self.config.grid_cell_capacity
            if d[D_ROWKHIT]:
                new["grid_pair_k"] = min(
                    2 * self.config.grid_pair_k,
                    new.get("grid_cell_capacity", self.config.grid_cell_capacity))
            if src & 8:
                new["max_compound_pairs"] = 2 * self.config.max_compound_pairs
            changed = {k: v for k, v in new.items() if v != getattr(self.config, k)}
            if changed:
                self.reconfigure(**changed)
                resized_store = "max_pairs" in changed
            if not bool(diag.overflow) or not changed:
                break
        return {"demand": d, "overflow": bool(self.last_diag.overflow), "rounds": rounds}

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

    # --- constraints -------------------------------------------------------------------
    def add_constraint(self, type_name: str, bodies, **params):
        """Add a joint (reference Solver.Add, Solver.cs:1208). ``bodies`` is a body handle
        or a list of handles; ``params`` are the type's description fields. Returns a
        handle (type_name, slot)."""
        if type_name not in JOINT_TYPES:
            raise KeyError(f"unknown constraint type '{type_name}'")
        if type_name not in self.joints:
            self.joints[type_name] = JointTypeStore(JOINT_TYPES[type_name],
                                                    self.config.joint_capacity)
        self._sync_from_device()
        self._dirty = True
        idx = self.joints[type_name].add(bodies, make_description(type_name, **params))
        # New constraints wake their bodies (reference Solver.Add awakens islands).
        for h in np.atleast_1d(bodies):
            if self._host.kind[int(h)] == KIND_DYNAMIC:
                self._host.awake[int(h)] = True
                self._host.sleep_timer[int(h)] = 0.0
        return (type_name, idx)

    def remove_constraint(self, handle) -> None:
        name, idx = handle
        self._sync_from_device()
        self._dirty = True
        self.joints[name].remove(idx)

    def update_constraint(self, handle, **params) -> None:
        name, idx = handle
        self._sync_from_device()
        self._dirty = True
        self.joints[name].update_description(idx, make_description(name, **params))

    def get_constraint(self, handle):
        """A constraint's body references, description fields and accumulated impulses
        (reference Solver.GetDescription, Solver.cs:1413): (bodies, params, impulses)."""
        name, idx = handle
        store = self.joints[name]
        if not store.valid[idx]:
            raise KeyError(f"constraint {handle} was removed")
        self._sync_from_device()
        nb = 1 if name in ONE_BODY_NAMES else store.n_bodies
        bodies = [int(b) for b in store.bodies[idx, :nb]]
        return bodies, unpack_fields(store.cls, store.prestep[idx]), np.array(store.impulse[idx])

    @property
    def constraint_count(self) -> int:
        return sum(s.count for s in self.joints.values())

    # --- state access ------------------------------------------------------------------
    def _pull(self) -> None:
        """Bring the host's columns up to the device state: a no-op where the host is the
        source of truth (``_dirty``) or already holds that state (after a push, or after
        a pull since the last step)."""
        if self._state is not None and not self._dirty and self._state is not self._mirrored:
            self._host.load(self._state.bodies)
            for name, imps in self._state.joint_impulses.items():
                self.joints[name].load_impulses(imps)
                if name in self._state.joint_colors:
                    self.joints[name].load_colors(self._state.joint_colors[name])
            self._mirrored = self._state

    def _sync_from_device(self) -> None:
        """Before a host edit: pull, and make the host the source of truth."""
        self._pull()
        self._dirty = True

    def _push(self) -> None:
        cfg = self.config
        cap, page = cfg.store_layout()
        cc_cap = cfg.compound_capacity()
        st = self._state
        stale = self._colors_stale
        legacy = not cfg.use_pair_store
        store = st.store if st is not None and not legacy else None
        cache = st.cache if st is not None and legacy else None
        if legacy and cache is None:
            cache = PairCache.empty(cfg.max_pairs, device=self.device)
        ccache = st.ccache if st is not None else PairCache.empty(cc_cap, device=self.device)
        if stale:
            # A body's kind changed or a slot was recycled: every carried color and the
            # store (its colors, claims and hash key off body slots) reset; constraints
            # re-propose colors over the next frames.
            store = None
            ccache = ccache._replace(color=torch.full_like(ccache.color, -1))
            if legacy:
                cache = cache._replace(color=torch.full_like(cache.color, -1))
            for js in self.joints.values():
                js.color[:] = -1
            self._colors_stale = False
        if store is None and not legacy:
            store = PairStore.empty(cap, cfg.body_capacity, page, device=self.device)
        keep = st is not None and not stale
        sleep_ccache = st.sleep_ccache if keep else PairCache.empty(cc_cap, device=self.device)
        sleep_cache = None
        if legacy:
            sleep_cache = (st.sleep_cache if keep and st.sleep_cache is not None
                           else PairCache.empty(cfg.max_pairs, device=self.device))
        t = lambda a: to_device(a, self.device)
        live = {name: js for name, js in self.joints.items() if js.count > 0}
        self._state = SimState(self._host.device(self.device), cache, ccache,
                               {n: t(js.impulse) for n, js in live.items()},
                               {n: t(js.color) for n, js in live.items()}, sleep_cache,
                               sleep_ccache, store)
        self._mirrored = self._state
        self._dirty = False

    @property
    def state(self) -> SimState:
        if self._dirty:
            self._push()
        return self._state

    def get_body(self, handle: int):
        """Host view of one body: (position, orientation, velocity, angular velocity)."""
        self._pull()
        h = self._host
        return (
            np.array([h.px[handle], h.py[handle], h.pz[handle]]),
            np.array([h.qx[handle], h.qy[handle], h.qz[handle], h.qw[handle]]),
            np.array([h.vx[handle], h.vy[handle], h.vz[handle]]),
            np.array([h.wx[handle], h.wy[handle], h.wz[handle]]),
        )

    # --- host-side setters (reference BodyReference; each wakes a dynamic body) --------
    def _wake_host(self, handle: int) -> None:
        if self._host.kind[handle] == KIND_DYNAMIC:
            self._host.awake[handle] = True
            self._host.sleep_timer[handle] = 0.0

    def set_pose(self, handle: int, position=None, orientation=None) -> None:
        """Teleport a body (reference BodyReference.Pose)."""
        self._sync_from_device()
        self._dirty = True
        h = self._host
        if position is not None:
            h.px[handle], h.py[handle], h.pz[handle] = position
        if orientation is not None:
            h.qx[handle], h.qy[handle], h.qz[handle], h.qw[handle] = orientation
        self._wake_host(handle)

    def set_local_inertia(self, handle: int, inv_mass: float, inv_inertia) -> None:
        """A body's inverse mass and local inverse inertia (xx, yx, yy, zx, zy, zz)
        (reference BodyReference.SetLocalInertia)."""
        self._sync_from_device()
        self._dirty = True
        h = self._host
        h.inv_mass[handle] = inv_mass
        h.ixx[handle], h.iyx[handle], h.iyy[handle], h.izx[handle], h.izy[handle], h.izz[handle] = inv_inertia
        self._wake_host(handle)

    def set_body_kind(self, handle: int, kind: int) -> None:
        """Kinematic ↔ dynamic (reference Bodies.cs:504): becoming kinematic zeroes the
        inverse mass and inertia; becoming dynamic needs a following
        ``set_local_inertia``. Carried colors reset (the conflict structure changed)."""
        if kind not in (KIND_DYNAMIC, KIND_KINEMATIC):
            raise ValueError("set_body_kind supports dynamic/kinematic only")
        self._sync_from_device()
        self._dirty = True
        self._colors_stale = True
        h = self._host
        h.kind[handle] = kind
        if kind == KIND_KINEMATIC:
            h.inv_mass[handle] = 0.0
            h.ixx[handle] = h.iyx[handle] = h.iyy[handle] = 0.0
            h.izx[handle] = h.izy[handle] = h.izz[handle] = 0.0
        h.awake[handle] = True
        h.sleep_timer[handle] = 0.0

    def wake_body(self, handle: int) -> None:
        """Explicit wake (reference Bodies.Awaken)."""
        self._sync_from_device()
        self._dirty = True
        self._wake_host(handle)

    def set_velocity(self, handle: int, linear=None, angular=None) -> None:
        self._sync_from_device()
        self._dirty = True
        self._wake_host(handle)
        h = self._host
        if linear is not None:
            h.vx[handle], h.vy[handle], h.vz[handle] = linear
        if angular is not None:
            h.wx[handle], h.wy[handle], h.wz[handle] = angular

    def state_hash(self) -> int:
        """Deterministic hash of the full device state (reference
        InvasiveHashDiagnostics.cs:10 — cross-run divergence bisection)."""
        if self._dirty:
            self._push()
        h = hashlib.sha256()
        for leaf in _leaves(self._state):
            h.update(leaf.detach().cpu().numpy().tobytes())
        return int.from_bytes(h.digest()[:8], "little")

    # --- queries (reference Simulation_Queries.cs) --------------------------------------
    def _child_targets(self):
        """(owner, child row) of every child of every compound and mesh body, in body slot
        order, on the device: (K,) int32 each, or (None, None) without such a body; and
        the shape types of the bodies and of those children (TRIANGLE for a mesh's).
        Read from the host's shape and kind columns, which only host calls change, so no
        sync with the device."""
        h = self._host
        key = (h.shape.tobytes(), h.kind.tobytes(), id(self.shapes), self.shapes._child_used)
        cached = getattr(self, "_child_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        shape = h.shape.astype(np.int64)
        types = np.where(shape >= 0, self.shapes.types[np.maximum(shape, 0)], -1)
        body_types = tuple(int(t) for t in np.unique(types[(h.kind != 0) & (shape >= 0)]))
        bodies = np.nonzero((h.kind != 0) & (shape >= 0)
                            & np.isin(types, (COMPOUND, BIG_COMPOUND, MESH)))[0]
        counts = self.shapes.child_count[shape[bodies]].astype(np.int64)
        if counts.sum() == 0:
            out = (None, None, body_types, ())
        else:
            owners = np.repeat(bodies, counts)
            first = np.repeat(self.shapes.child_start[shape[bodies]].astype(np.int64), counts)
            within = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
            rows = first + within
            kids = self.shapes.child_shape[rows].astype(np.int64)
            child_types = np.where(kids >= 0, self.shapes.types[np.maximum(kids, 0)], TRIANGLE)
            out = (to_device(owners.astype(np.int32), self.device),
                   to_device(rows.astype(np.int32), self.device), body_types,
                   tuple(int(t) for t in np.unique(child_types)))
        self._child_cache = (key, out)
        return out

    def ray_cast(self, origin, direction, max_t: float = 1.0e30, exclude: int = None,
                 prune_k: int = 0):
        """Scene ray cast (reference Simulation.RayCast, Simulation_Queries.cs:167).
        ``origin`` / ``direction``: 3-tuples, or (R, 3) arrays for a batch. ``exclude``: a
        body handle to skip. ``prune_k`` (batches only): test only the K bodies whose
        bounding spheres each ray enters first; ``saturated`` flags rays where a body
        left out could hit first. Returns ``RayHit`` of tensors on the device (no sync)."""
        from .collision.raycast import ray_cast_all

        if self._dirty:
            self._push()
        o = np.asarray(origin, np.float32)
        d = np.asarray(direction, np.float32)
        up = to_device(np.concatenate([o.reshape(-1, 3), d.reshape(-1, 3)], -1), self.device)
        cols = [up[:, i] for i in range(6)]
        if o.ndim == 1:
            cols = [c[0] for c in cols]
        co, cr, body_types, child_types = self._child_targets()
        return ray_cast_all(
            self._state.bodies, self.shapes.device(self.device), Vec3(*cols[:3]),
            Vec3(*cols[3:]), float(np.float32(max_t)), exclude=exclude,
            child_owner=co, child_rows=cr, prune_k=prune_k, body_types=body_types,
            child_types=child_types,
        )

    def box_query(self, box_min, box_max):
        """Handles of every body whose AABB overlaps the query box (reference
        Tree_VolumeQuery): one pass over the exact per-shape AABBs. Returns a list."""
        if self._dirty:
            self._push()
        b = self._state.bodies
        lo = [float(v) for v in np.asarray(box_min, np.float32)]
        hi = [float(v) for v in np.asarray(box_max, np.float32)]
        amin, amax = compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape,
                                         self.shapes.device(self.device), 0.0,
                                         present_types=self._present_types())
        ok = (b.exists & (b.shape >= 0)
              & (amax.x >= lo[0]) & (amin.x <= hi[0])
              & (amax.y >= lo[1]) & (amin.y <= hi[1])
              & (amax.z >= lo[2]) & (amin.z <= hi[2]))
        return np.nonzero(ok.cpu().numpy())[0].tolist()

    def contacts(self):
        """The convex contact records after the last step (reference ContactEventsDemo),
        the pair store's live ones or the legacy cache's: a list of dicts of bodies and
        accumulated impulses."""
        if self._state is None:
            return []
        st = self._state.store
        if st is None:
            c = self._state.cache
            nb = self.config.body_capacity
            keys, pen = c.key.cpu().numpy(), c.penetration.cpu().numpy()
            return [dict(body_a=int(keys[i]) % nb, body_b=int(keys[i]) // nb,
                         impulses=pen[i].tolist())
                    for i in np.nonzero(c.valid.cpu().numpy())[0]]
        valid = (st.live & st.active_prev).cpu().numpy()
        a, b, pen = (x.cpu().numpy() for x in (st.body_a, st.body_b, st.imp_pen))
        return [dict(body_a=int(a[i]), body_b=int(b[i]), impulses=pen[i].tolist())
                for i in np.nonzero(valid)[0]]

    def live_contact_pairs(self) -> set:
        """(body_a, body_b) pairs with live contact records after the last step: the pair
        store's (or the legacy cache's, b-major keys b x NB + a), and the compound child
        cache's, keyed pair_key x sub_cap + slot."""
        cur = set()
        if self._state is None:
            return cur
        nb = self.config.body_capacity
        st = self._state.store
        if st is None:
            c = self._state.cache
            keys = c.key.cpu().numpy()[c.valid.cpu().numpy()].astype(np.int64)
            cur.update((int(k % nb), int(k // nb)) for k in keys)
        else:
            valid = (st.live & st.active_prev).cpu().numpy()
            aa, bb = st.body_a.cpu().numpy(), st.body_b.cpu().numpy()
            cur.update((int(aa[i]), int(bb[i])) for i in np.nonzero(valid)[0])
        cc = self._state.ccache
        keys = cc.key.cpu().numpy()[cc.valid.cpu().numpy()].astype(np.int64)
        pk = keys // self.config.compound_sub_cap()
        cur.update((int(k % nb), int(k // nb)) for k in pk)
        return cur

    def contact_events(self):
        """Contact begin / persist / end events since the previous call (reference
        ContactEventsDemo): {'began', 'persisted', 'ended'} sets of (body_a, body_b).
        A pair whose bodies fell asleep keeps its contact (reference
        PairCache_Activity.cs): a sleeping stack emits no 'ended'."""
        cur = self.live_contact_pairs()
        prev = getattr(self, "_prev_contact_pairs", set())
        self._pull()
        h = self._host
        for p in prev - cur:
            a, b = p
            live = h.kind[a] != 0 and h.kind[b] != 0
            asleep_a = (h.kind[a] != KIND_DYNAMIC) or not h.awake[a]
            asleep_b = (h.kind[b] != KIND_DYNAMIC) or not h.awake[b]
            if live and asleep_a and asleep_b:
                cur.add(p)
        self._prev_contact_pairs = cur
        return {"began": cur - prev, "persisted": cur & prev, "ended": prev - cur}

    def _sweep_args(self, shape_obj):
        """(type id, packed params (12,), the registry row of this very object or -1)."""
        type_id, packed = shape_obj.pack()
        params = np.zeros(12, np.float32)
        params[: len(packed)] = packed
        row = next((r for r, s in enumerate(self.shapes.shapes) if s is shape_obj), -1)
        return type_id, params, row

    def _sweep(self, shape_obj, poses, max_t, prune_k, batched):
        from .collision.sweeps import sweep_shape_all
        from .utils.vec import Quat

        if self._dirty:
            self._push()
        type_id, params, row = self._sweep_args(shape_obj)
        up = to_device(np.concatenate(poses, -1).astype(np.float32), self.device)
        cols = [up[:, i] for i in range(up.shape[1])]
        if not batched:
            cols = [c[0] for c in cols]
        co, cr, _, _ = self._child_targets()
        customs = tuple(t for t in self._present_types() if is_custom(t))
        return sweep_shape_all(
            self._state.bodies, self.shapes.device(self.device), type_id,
            to_device(params, self.device), row, Vec3(*cols[0:3]), Quat(*cols[3:7]), Vec3(*cols[7:10]),
            Vec3(*cols[10:13]), float(np.float32(shape_obj.maximum_radius())),
            float(np.float32(max_t)), child_owner=co, child_rows=cr, prune_k=prune_k,
            custom_ids=customs + ((type_id,) if is_custom(type_id) else ()),
        )

    def sweep_shape(self, shape_obj, position, velocity, max_t: float = 10.0,
                    orientation=(0, 0, 0, 1), angular_velocity=(0, 0, 0), prune_k: int = 0):
        """Shape sweep to the time of impact by conservative advancement, angular velocity
        included (reference Simulation.Sweep, Simulation_Queries.cs:267). Returns
        ``SweepHit(hit, t, body)`` of tensors on the device."""
        poses = [np.asarray(v, np.float32).reshape(1, -1)
                 for v in (position, orientation, velocity, angular_velocity)]
        return self._sweep(shape_obj, [poses[0], poses[1], poses[2], poses[3]], max_t,
                           prune_k, batched=False)

    def sweep_shape_batch(self, shape_obj, positions, velocities, max_t: float = 10.0,
                          orientations=None, angular_velocities=None, prune_k: int = 0):
        """R shape sweeps against the whole scene in one pass over (R, targets) records.
        ``positions`` / ``velocities``: (R, 3); ``orientations`` (R, 4) and
        ``angular_velocities`` (R, 3) optional. ``prune_k``: advance only each sweep's K
        earliest candidates; ``saturated`` flags sweeps that may be inexact. Returns
        ``SweepHit`` with (R,) tensors on the device."""
        P = np.asarray(positions, np.float32).reshape(-1, 3)
        R = P.shape[0]
        O = (np.asarray(orientations, np.float32) if orientations is not None
             else np.tile(np.array([0, 0, 0, 1], np.float32), (R, 1)))
        V = np.asarray(velocities, np.float32).reshape(R, 3)
        W = (np.asarray(angular_velocities, np.float32) if angular_velocities is not None
             else np.zeros((R, 3), np.float32))
        return self._sweep(shape_obj, [P, O, V, W], max_t, prune_k, batched=True)

    def sweep(self, shape_obj, position, direction, max_t: float = 100.0, samples: int = 64):
        """Coarse bounding-sphere sweep on the host (use ``sweep_shape`` for an exact time
        of impact). Returns (hit, t, body)."""
        self._pull()
        pos = np.asarray(position, np.float64)
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        r = shape_obj.maximum_radius()
        h = self._host
        exists = (h.kind != 0) & (h.shape >= 0)
        centers = np.stack([h.px, h.py, h.pz], -1)
        radii = np.array([self.shapes.max_radius[h.shape[i]] if h.shape[i] >= 0 else 0.0
                          for i in range(len(h.shape))])
        best_t, best_b = float("inf"), -1
        for i in np.nonzero(exists)[0]:
            rel = centers[i] - pos
            proj = float(rel @ d)
            perp2 = float(rel @ rel) - proj * proj
            rr = (r + radii[i]) ** 2
            if perp2 > rr:
                continue
            t_hit = proj - np.sqrt(max(rr - perp2, 0.0))
            if 0.0 <= t_hit <= max_t and t_hit < best_t:
                best_t, best_b = t_hit, int(i)
        return (best_b >= 0, best_t if best_b >= 0 else max_t, best_b)

    # --- stepping ----------------------------------------------------------------------
    def _present_types(self):
        return tuple(sorted({int(t) for t in self.shapes.types if t >= 0}))

    def _mesh_bodies(self) -> int:
        """How many bodies are meshes, from the host's columns (no sync)."""
        h = self._host
        shape = h.shape[(h.kind != KIND_EMPTY) & (h.shape >= 0)]
        return int((self.shapes.types[shape] == MESH).sum())

    def _joint_banks(self, device=None) -> dict:
        """The joint banks of every type with a live constraint, on ``device`` (the
        simulation's by default); impulses ride in the state."""
        dev = self.device if device is None else device
        return {name: {k: v for k, v in js.device(dev).items() if k != "impulse"}
                for name, js in self.joints.items() if js.count > 0}

    def timestep(self, dt: float = 1.0 / 60.0) -> None:
        if self._dirty:
            self._push()
        self._state, self.last_diag = _step_impl(
            self._state, self.shapes.device(self.device), self._joint_banks(), dt, self.config,
            self._present_types(), self._mesh_bodies() > 1,
        )

    def save_checkpoint(self) -> bytes:
        """The full device state as npz bytes, accumulated impulses included so warm starts
        survive (reference parity: Solver.GetDescription, EnumerateAccumulatedImpulses)."""
        from .checkpoint import state_to_bytes

        if self._dirty:
            self._push()
        return state_to_bytes(self._state)

    def load_checkpoint(self, data: bytes) -> None:
        """Restore a state saved by ``save_checkpoint`` on a simulation of the same
        capacities and topology."""
        from .checkpoint import state_from_bytes

        if self._dirty:
            self._push()
        self._state = state_from_bytes(self._state, data)
        self._dirty = False
        self._host.load(self._state.bodies)
        self._mirrored = self._state

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
