"""Narrow phase: type-pair dispatch → manifolds → contact prestep records, with
row-local warm-start carry from the pair store and keyed carry for compound children.

Counterpart of ``run_convex_testers``, ``convex_pair_records``, ``narrow_phase_store``,
``PairCache``, ``narrow_phase`` (the legacy per-frame path, with ``update_cache``),
``narrow_phase_compound``, ``update_cache_keyed`` and ``retain_sleeping`` in
``bepuphysics2_tpu/collision/narrowphase.py``, for every convex shape (the analytic
testers, and the generic GJK/MPR path of ``convex.py`` for the other pairs), compounds of
them and meshes, compound-vs-compound pairs included, with CCD (``ccd_eval_times`` and the
time-of-impact branch of ``convex_pair_records``, over ``sweeps.pair_toi``). The JAX
package's runtime ``lax.cond`` skips become unconditional passes whose result is selected
by the same predicate, so nothing waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bodies import BodyState, KIND_DYNAMIC
from ..constraints.contact import ContactImpulses, ContactPrestep
from ..shapes.custom import CUSTOM_SUPPORTS, is_custom
from ..shapes.registry import (
    BIG_COMPOUND, BOX, CAPSULE, COMPOUND, CONVEX_HULL, MESH, SPHERE, TRIANGLE, ShapeData,
)
from ..utils import replay
from ..utils.packing import compact_true, gather_rows
from ..utils.spring import SpringSettings
from ..utils.vec import Quat, Vec2, Vec3
from . import testers
from ..utils.vec import integrate_orientation
from .compound import expand_compound_compound, expand_compound_pairs
from .convex import SupportCtx, generic_convex_manifold
from .manifold import Manifold
from .sweeps import pair_toi

_BIG = 2**31 - 1


class PairCache(NamedTuple):
    """Last frame's contact records for keyed warm starting (reference PairCache.cs:102)."""

    key: torch.Tensor  # (MP,) int32 record key; dead rows +BIG (sort last)
    feature: torch.Tensor  # (MP, 4) int32
    penetration: torch.Tensor  # (MP, 4)
    tangent: Vec2  # (MP,)
    twist: torch.Tensor  # (MP,)
    valid: torch.Tensor  # (MP,) bool
    color: torch.Tensor  # (MP,) int32 solver color carried across frames; -1 = none
    body_a: torch.Tensor  # (MP,) int32 (color-claim accounting in the pair store)
    body_b: torch.Tensor  # (MP,) int32

    @staticmethod
    def empty(capacity: int, device=None) -> "PairCache":
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return PairCache(
            key=torch.full((capacity,), _BIG, dtype=torch.int32, device=device),
            feature=i(capacity, 4), penetration=f(capacity, 4),
            tangent=Vec2(f(capacity), f(capacity)), twist=f(capacity),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
            color=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            body_a=i(capacity), body_b=i(capacity),
        )

    def resized(self, capacity: int) -> "PairCache":
        """Grow (dead rows appended) or shrink (the lowest keys kept, so dead rows drop
        first) the bank (reference Simulation.Resize, Simulation.cs:332-415)."""
        cur = self.key.shape[0]
        if capacity == cur:
            return self
        if capacity > cur:
            pad = PairCache.empty(capacity - cur, device=self.key.device)
            return _tree_map2(lambda a, b: torch.cat([a, b]), self, pad)
        order = torch.sort(self.key, stable=True).indices[:capacity]
        return gather_rows(self, order)


def _tree_map2(fn, a, b):
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return type(a)(*(_tree_map2(fn, x, y) for x, y in zip(a, b)))


def pair_key(body_a, body_b, n_bodies: int):
    """Pair identity for the warm-start caches: b-major (b = the larger slot)."""
    return body_b * n_bodies + body_a


def _sphere_sphere(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_sphere(pos_ab, pa, pb)


def _sphere_capsule(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_capsule(pos_ab, orn_b, pa, pb)


def _sphere_box(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_box(pos_ab, orn_b, pa, pb)


def _capsule_capsule(pos_ab, orn_a, orn_b, pa, pb):
    return testers.capsule_capsule(pos_ab, orn_a, orn_b, pa, pb)


def _box_box(pos_ab, orn_a, orn_b, pa, pb):
    return testers.box_box(pos_ab, orn_a, orn_b, pa, pb)


def _capsule_box(pos_ab, orn_a, orn_b, pa, pb):
    return testers.capsule_box(pos_ab, orn_a, orn_b, pa, pb)


def _sphere_triangle(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_triangle(pos_ab, orn_b, pa, pb)


def _capsule_triangle(pos_ab, orn_a, orn_b, pa, pb):
    return testers.capsule_triangle(pos_ab, orn_a, orn_b, pa, pb)


def _box_triangle(pos_ab, orn_a, orn_b, pa, pb):
    return testers.box_triangle(pos_ab, orn_a, orn_b, pa, pb)


# Registered convex type-pair testers (canonical order: type_a <= type_b). Every other
# convex pair goes through the generic GJK/MPR path (``convex.py``).
TESTER_REGISTRY = [
    (SPHERE, SPHERE, _sphere_sphere),
    (SPHERE, CAPSULE, _sphere_capsule),
    (SPHERE, BOX, _sphere_box),
    (SPHERE, TRIANGLE, _sphere_triangle),
    (CAPSULE, CAPSULE, _capsule_capsule),
    (CAPSULE, BOX, _capsule_box),
    (CAPSULE, TRIANGLE, _capsule_triangle),
    (BOX, BOX, _box_box),
    (BOX, TRIANGLE, _box_triangle),
]


def convex_type_mask(t, custom_ids):
    """Which of the type ids ``t`` are convex: a built-in convex type or one of the custom
    types ``custom_ids``."""
    m = (t >= 0) & (t <= CONVEX_HULL)
    for tid in custom_ids:
        m = m | (t == tid)
    return m


def _convex_ids(present):
    """The convex type ids a scene can hold: the built-in ones, and the registered custom
    ones among ``present`` (every registered one where ``present`` is None)."""
    customs = CUSTOM_SUPPORTS if present is None else [p for p in present if is_custom(p)]
    return tuple(range(CONVEX_HULL + 1)) + tuple(sorted(customs))


def run_convex_testers(
    shapes: ShapeData,
    ti, tj, params_i, params_j, pos_i, pos_j, orn_i, orn_j, shape_i, shape_j,
    valid, present_types=None, include_triangles=False, meshes_meet=True,
) -> Manifold:
    """Run the analytic tester registry and the generic GJK/MPR fallback over canonical
    (type_i ≤ type_j) convex pair records. ``shape_i/j``: registry rows (−1 = raw
    triangle params of a mesh child). Returns a manifold relative to the i-side pose.

    Which testers run is decided on the host from ``present_types`` (the registry's
    types): a type pair that cannot occur runs nothing, the fallback runs only where the
    scene's convex types can form a pair outside the registry, and its hull gather only
    where a hull is present, so a scene of spheres, boxes and capsules launches what it
    did before the fallback existed. ``include_triangles`` adds the triangle of a mesh's
    children where a mesh is present; ``meshes_meet`` False says that two of those can
    never form a record (at most one mesh body and no triangle shape registered), so the
    triangle-triangle pair alone does not call for the fallback."""
    mp = ti.shape[0]
    dev = ti.device
    pos_ij = pos_j - pos_i
    manifold = Manifold.empty(mp, device=dev)
    present = set(present_types) if present_types is not None else None
    analytic = {(t0, t1) for t0, t1, _ in TESTER_REGISTRY}
    if present is not None and include_triangles and MESH in present:
        if TRIANGLE not in present and not meshes_meet:
            analytic.add((TRIANGLE, TRIANGLE))  # no record can pair two triangles
        present = present | {TRIANGLE}
    convex = _convex_ids(present)
    in_scene = convex if present is None else [t for t in convex if t in present]
    generic = any((x, y) not in analytic for xi, x in enumerate(in_scene) for y in in_scene[xi:])
    covered = torch.zeros(mp, dtype=torch.bool, device=dev) if generic else None
    for t0, t1, fn in TESTER_REGISTRY:
        if present is not None and (t0 not in present or t1 not in present):
            continue  # this type pair cannot occur in the scene
        sel_types = (ti == t0) & (tj == t1)
        if generic:
            covered = covered | sel_types
        m = fn(pos_ij, orn_i, orn_j, params_i, params_j)
        manifold = m.where(valid & sel_types, manifold)
    if not generic:
        return manifold
    # Generic support-mapping fallback for every other convex pair.
    hulls = present is None or CONVEX_HULL in present
    rows = lambda s: shapes.hull_rows[s.clamp_min(0).long()]
    ctx = SupportCtx(
        type_a=ti, params_a=params_i, type_b=tj, params_b=params_j,
        orn_ab=orn_i.conjugate().mul(orn_j), pos_ab=orn_i.rotate_inverse(pos_ij),
        hull_points=Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z) if hulls else None,
        hull_rows_a=rows(shape_i) if hulls else None,
        hull_rows_b=rows(shape_j) if hulls else None,
        custom_ids=tuple(t for t in in_scene if t > CONVEX_HULL),
    )
    # One replayed graph on the card (``utils/replay.py``): 48 masked iterations.
    data = {k: v for k, v in ctx._asdict().items() if k != "custom_ids" and v is not None}
    gm = replay.run(
        ("generic manifold", hulls, ctx.custom_ids,
         tuple(CUSTOM_SUPPORTS[t] for t in ctx.custom_ids)),
        lambda d: generic_convex_manifold(
            SupportCtx(**{**ctx._asdict(), **{k: v for k, v in d.items() if k != "orn_i"}}),
            d["orn_i"]),
        dict(data, orn_i=orn_i))
    convex_pair = convex_type_mask(ti, ctx.custom_ids) & convex_type_mask(tj, ctx.custom_ids)
    return gm.where(valid & convex_pair & ~covered, manifold)


def convex_pair_records(
    state: BodyState,
    shapes: ShapeData,
    a, b, valid,
    dt,
    spec_margin_max: float = 1.0e30,
    present_types: tuple = None,
    max_ccd: int = 0,
):
    """Convex manifolds + contact prestep records for an explicit (a, b, valid) pair set.

    ``max_ccd > 0`` turns on continuous collision detection (reference
    ContinuousDetectionMode.Continuous): the pairs with a continuous body whose relative
    displacement this step risks tunnelling are swept to their time of impact
    (``_ccd_times``), evaluated at the poses advanced to it, and their depths warped back
    to t = 0 as speculative contacts, so the solver stops the approach at the impact.
    Returns (prestep, t_eval); t_eval (per pair; 0 where not swept) is None without CCD."""
    shp = state.shape.clamp_min(0).long()
    btype = torch.where(state.shape >= 0, shapes.type[shp], -1)
    bparams = shapes.params[shp]
    # One packed per-body row: pose, velocity, material, shape row/type, params.
    bodyf = torch.cat(
        [
            torch.stack(
                [
                    state.pos.x, state.pos.y, state.pos.z,
                    state.orn.x, state.orn.y, state.orn.z, state.orn.w,
                    state.vel.x, state.vel.y, state.vel.z,
                    state.friction, state.spring_frequency, state.spring_damping,
                    state.max_recovery_velocity,
                    state.spec_margin_min, state.spec_margin_max,
                    shp.float(),
                    btype.float(),
                ],
                -1,
            ),
            bparams,
        ],
        dim=-1,
    )
    fa = bodyf[a.long()]
    fb = bodyf[b.long()]

    shape_a = fa[:, 16].to(torch.int32)
    shape_b = fb[:, 16].to(torch.int32)
    ta = fa[:, 17].to(torch.int32)
    tb = fb[:, 17].to(torch.int32)

    swap = ta > tb
    ti = torch.where(swap, tb, ta)
    tj = torch.where(swap, ta, tb)
    shape_i = torch.where(swap, shape_b, shape_a)
    shape_j = torch.where(swap, shape_a, shape_b)
    s1 = swap[:, None]
    params_i = torch.where(s1, fb[:, 18:30], fa[:, 18:30])
    params_j = torch.where(s1, fa[:, 18:30], fb[:, 18:30])
    fi = torch.where(s1, fb, fa)
    fj = torch.where(s1, fa, fb)
    pos_i = Vec3(fi[:, 0], fi[:, 1], fi[:, 2])
    pos_j = Vec3(fj[:, 0], fj[:, 1], fj[:, 2])
    orn_i = Quat(fi[:, 3], fi[:, 4], fi[:, 5], fi[:, 6])
    orn_j = Quat(fj[:, 3], fj[:, 4], fj[:, 5], fj[:, 6])
    vel_a = Vec3(fa[:, 7], fa[:, 8], fa[:, 9])
    vel_b = Vec3(fb[:, 7], fb[:, 8], fb[:, 9])

    t_eval = None
    if max_ccd > 0:
        t_eval = _ccd_times(state, shapes, a, b, valid, dt, max_ccd, present_types)
        # The swept pairs' manifolds at their poses advanced to the time of impact.
        i = torch.where(swap, b, a).long()
        j = torch.where(swap, a, b).long()
        pos_i = pos_i + state.vel[i] * t_eval
        pos_j = pos_j + state.vel[j] * t_eval
        orn_i = integrate_orientation(orn_i, state.omega[i], t_eval)
        orn_j = integrate_orientation(orn_j, state.omega[j], t_eval)

    manifold = run_convex_testers(
        shapes, ti, tj, params_i, params_j, pos_i, pos_j, orn_i, orn_j,
        shape_i, shape_j, valid, present_types,
    )
    # Un-flip swapped pairs: offsets relative to scene body a, normal from b to a.
    manifold = manifold.flipped(pos_i - pos_j).where(swap, manifold)
    if t_eval is not None:
        # Warp the depths back to t = 0: depth(0) = depth(t) + n·(v_a − v_b)·t (the normal
        # points B→A, so an approaching pair gets the speculative depth that lets the
        # solver allow exactly the approach up to the impact).
        vn = manifold.normal.dot(vel_a - vel_b)
        manifold = manifold._replace(depth=manifold.depth + (vn * t_eval)[:, None])

    # Speculative margin acceptance (reference Collidable.cs:115,131,139).
    rel_speed = (vel_a - vel_b).length()
    pair_min = 0.5 * (fa[:, 14] + fb[:, 14])
    pair_max = torch.clamp_max(torch.minimum(fa[:, 15], fb[:, 15]), spec_margin_max)
    margin = torch.clamp(rel_speed * dt + pair_min, min=torch.zeros_like(pair_min),
                         max=torch.maximum(pair_min, pair_max))
    contact_ok = manifold.contact_mask & (manifold.depth > -margin[:, None])
    record_valid = valid & contact_ok.any(dim=-1)

    # Pair material: geometric-mean friction, min spring / recovery, max damping.
    friction = torch.sqrt(fa[:, 10] * fb[:, 10])
    freq = torch.minimum(fa[:, 11], fb[:, 11])
    damping = torch.maximum(fa[:, 12], fb[:, 12])
    max_rec = torch.minimum(fa[:, 13], fb[:, 13])

    prestep = ContactPrestep(
        body_a=a,
        body_b=b,
        normal=manifold.normal,
        offset_a=manifold.offset_a,
        offset_b=Vec3(fb[:, 0] - fa[:, 0], fb[:, 1] - fa[:, 1], fb[:, 2] - fa[:, 2]),
        depth=manifold.depth,
        contact_mask=contact_ok,
        valid=record_valid,
        friction=friction,
        spring=SpringSettings.make(freq, damping),
        max_recovery_velocity=max_rec,
        feature=manifold.feature,
    )
    return prestep, t_eval


def _ccd_times(state, shapes, a, b, valid, dt, max_ccd, present_types):
    """The CCD evaluation time of every pair: the tunnelling-risk gate (a continuous body,
    a relative displacement this step above half the smaller shape's radius), the risk
    pairs compacted on the device into ``max_ccd`` slots in pair order (the pairs past it
    keep t = 0), ``pair_toi`` over them, and the times scattered back: (MP,) float32."""
    mp = a.shape[0]
    al, bl = a.long(), b.long()
    ra = shapes.max_radius[state.shape[al].clamp_min(0).long()]
    rb = shapes.max_radius[state.shape[bl].clamp_min(0).long()]
    rel_disp = (state.vel[al] - state.vel[bl]).length() * dt
    cont = state.continuity
    risk = valid & ((cont[al] > 0) | (cont[bl] > 0)) & (rel_disp > 0.5 * torch.minimum(ra, rb))
    sel, count = compact_true(risk, max_ccd)
    live = torch.arange(max_ccd, device=a.device) < count
    present = None if present_types is None else set(present_types)
    composites = present is None or bool(present & {COMPOUND, BIG_COMPOUND, MESH})
    customs = tuple(t for t in (CUSTOM_SUPPORTS if present is None else present)
                    if is_custom(t))
    sl = sel.long()
    t_hit = pair_toi(state, shapes, a[sl], b[sl], live, dt, composites=composites,
                     custom_ids=customs)
    t_eval = torch.zeros(mp + 1, dtype=torch.float32, device=a.device)
    t_eval[torch.where(live, sl, mp)] = t_hit
    return t_eval[:mp]


def ccd_eval_times(state, shapes, a, b, valid, dt, max_ccd: int, present_types=None):
    """A CCD pass over an explicit pair set, with the gate and the advancement of the
    convex records: (MP,) evaluation times. The store path takes the compound expansion's
    times from it (its pair list is the broad phase's candidates, not the store's slots)."""
    return _ccd_times(state, shapes, a, b, valid, dt, max_ccd, present_types)


def narrow_phase_store(
    state: BodyState,
    shapes: ShapeData,
    store,
    active,
    dt,
    spec_margin_max: float = 1.0e30,
    present_types: tuple = None,
    max_ccd: int = 0,
):
    """Manifolds for every store slot with ROW-LOCAL warm-start carry: a pair's previous
    features and impulses live in the same slot (reference PairCache.cs:78 feature-id
    redistribution as an elementwise compare). Returns (prestep, imp, t_eval)."""
    prestep, t_eval = convex_pair_records(
        state, shapes, store.body_a, store.body_b, active, dt,
        spec_margin_max=spec_margin_max, present_types=present_types, max_ccd=max_ccd,
    )
    eq = (
        (prestep.feature[:, :, None] == store.feature[:, None, :])
        & prestep.contact_mask[:, :, None]
        & (store.feature[:, None, :] >= 0)
    )
    matched = store.active_prev & prestep.valid
    pen = torch.where(eq, store.imp_pen[:, None, :], 0.0).sum(dim=-1)
    pen = torch.where(matched[:, None], pen, 0.0)
    imp = ContactImpulses(
        penetration=pen,
        tangent=Vec2(
            torch.where(matched, store.imp_tx, 0.0),
            torch.where(matched, store.imp_ty, 0.0),
        ),
        twist=torch.where(matched, store.imp_tw, 0.0),
    )
    return prestep, imp, t_eval


def narrow_phase(state: BodyState, shapes: ShapeData, pairs, cache: PairCache, dt,
                 spec_margin_max: float = 1.0e30, present_types: tuple = None,
                 max_ccd: int = 0, pairs_sorted: bool = False, sleep_bank: PairCache = None):
    """The legacy per-frame candidate path (``SimConfig.use_pair_store=False``, and the
    sharded step): records for every broad-phase candidate, with a sorted-join warm-start
    carry against the previous frame's ``PairCache`` by pair key and feature id.
    ``pairs_sorted``: the candidates come in ascending b-major key order (the brute
    force, and ``brute_force_rows``), so last frame's cache is sorted by construction and
    the join skips its sort. Returns (prestep, impulses, carried colors, t_eval)."""
    n_bodies = state.pos.x.shape[0]
    prestep, t_eval = convex_pair_records(
        state, shapes, pairs.a, pairs.b, pairs.valid, dt, spec_margin_max=spec_margin_max,
        present_types=present_types, max_ccd=max_ccd)
    imp, carried_color = _warm_start_from_cache(prestep, cache, n_bodies,
                                                presorted=pairs_sorted, sleep_bank=sleep_bank)
    return prestep, imp, carried_color, t_eval


def _warm_start_from_cache(prestep: ContactPrestep, cache: PairCache, n_bodies: int,
                           presorted: bool = False, sleep_bank: PairCache = None):
    """The keyed carry of ``_warm_start_from_cache_keyed`` with b-major pair keys."""
    key = pair_key(prestep.body_a, prestep.body_b, n_bodies)
    return _warm_start_from_cache_keyed(prestep, cache, key, presorted=presorted,
                                        sleep_bank=sleep_bank)


def update_cache(prestep: ContactPrestep, imp: ContactImpulses, n_bodies: int, color,
                 slot_live=None) -> PairCache:
    """This frame's records as next frame's warm-start cache; ``color`` is the solver
    color each record took (-1: Jacobi or none, retried next frame). Keys are masked by
    ``slot_live`` (the broad phase's live slots, a prefix of the list), not by
    ``prestep.valid``: records without contacts sit between ones with contacts, and
    masking their keys would break the ascending order the presorted join relies on. The
    carry itself is still gated by ``valid`` at match time."""
    live = prestep.valid if slot_live is None else slot_live
    key = torch.where(live, pair_key(prestep.body_a, prestep.body_b, n_bodies), _BIG)
    return PairCache(key=key.to(torch.int32), feature=prestep.feature,
                     penetration=imp.penetration, tangent=imp.tangent, twist=imp.twist,
                     valid=prestep.valid, color=color.to(torch.int32),
                     body_a=prestep.body_a, body_b=prestep.body_b)


def narrow_phase_compound(
    state: BodyState,
    shapes: ShapeData,
    pairs,
    cache: PairCache,
    dt,
    max_compound_pairs: int,
    children_per_pair: int,
    child_window: int,
    present_types: tuple = None,
    max_cc_pairs: int = 0,
    cc_children_per_side: int = 4,
    sleep_bank: PairCache = None,
    pair_t=None,
    meshes_meet: bool = True,
):
    """Compound pair path: expand compound-vs-convex pairs (meshes count as compounds)
    into child convex records and build a second contact bank (``collision/compound.py``).
    ``max_cc_pairs > 0`` also expands compound-vs-compound pairs into child x child
    records, after the others, in a slot space of their own. Cache keys combine the pair
    key with the child slot. ``meshes_meet`` False: the host knows that no two mesh
    triangles can meet (one mesh body at most), so with no triangle shape registered no
    record pairs two triangles and the generic fallback is not needed for one. Returns
    (prestep, impulses, carried colors, keys, overflow)."""
    n_bodies = state.pos.x.shape[0]
    cp = expand_compound_pairs(
        state, shapes, pairs.a, pairs.b, pairs.valid, max_compound_pairs, children_per_pair,
        child_window, flag_both_comp=max_cc_pairs == 0, pair_t=pair_t, dt=dt,
    )
    sub = cp.slot % children_per_pair
    sub_cap = children_per_pair
    if max_cc_pairs > 0:
        cc = expand_compound_compound(
            state, shapes, pairs.a, pairs.b, pairs.valid, max_cc_pairs,
            cc_children_per_side, child_window,
        )
        per_pair = cc_children_per_side * cc_children_per_side
        sub = torch.cat([sub, children_per_pair + cc.slot % per_pair])
        sub_cap = children_per_pair + per_pair
        cp = _tree_map2(lambda x, y: torch.cat([x, y]) if x.dim() > 0 else x | y, cp, cc)

    manifold = run_convex_testers(
        shapes, cp.type_i, cp.type_j, cp.params_i, cp.params_j, cp.pos_i, cp.pos_j,
        cp.orn_i, cp.orn_j, cp.shape_i, cp.shape_j, cp.valid, present_types,
        include_triangles=True, meshes_meet=meshes_meet,
    )

    # Rebase offsets from the i-side pose to scene body_a's center (advanced to the
    # record's evaluation time); flip the normal when the i side is scene body_b.
    a, b = cp.body_a.long(), cp.body_b.long()
    rebase = cp.pos_i - (state.pos[a] + state.vel[a] * cp.t)
    manifold = manifold._replace(
        offset_a=Vec3(manifold.offset_a.x + rebase.x[:, None],
                      manifold.offset_a.y + rebase.y[:, None],
                      manifold.offset_a.z + rebase.z[:, None]),
        normal=manifold.normal.where(~cp.swapped, -1.0 * manifold.normal),
    )

    # Mesh triangles are one-sided, with near-face normals snapped onto the face
    # (reference MeshReduction.cs). Without meshes no record is a triangle, and this
    # leaves every record as it is.
    tri_i = (cp.type_i == TRIANGLE) & (cp.shape_i == -1)
    tri_j = (cp.type_j == TRIANGLE) & (cp.shape_j == -1)
    is_mesh_tri = tri_i | tri_j
    params_t = torch.where(tri_i[:, None], cp.params_i, cp.params_j)
    orn_t = cp.orn_i.where(tri_i, cp.orn_j)
    va = Vec3(params_t[:, 0], params_t[:, 1], params_t[:, 2])
    vb_ = Vec3(params_t[:, 3], params_t[:, 4], params_t[:, 5])
    vc = Vec3(params_t[:, 6], params_t[:, 7], params_t[:, 8])
    face_w = orn_t.rotate((vb_ - va).cross(vc - va).normalize())
    toward_conv = manifold.normal.where(cp.conv_is_a, -1.0 * manifold.normal)
    dotf = toward_conv.dot(face_w)
    front = ~is_mesh_tri | (dotf > -0.01)
    snap = is_mesh_tri & (dotf > 0.7) & (dotf < 0.99999)
    snapped_toward = face_w.where(snap, toward_conv)
    manifold = manifold._replace(
        normal=snapped_toward.where(cp.conv_is_a, -1.0 * snapped_toward),
        depth=torch.where(snap[:, None], manifold.depth * dotf[:, None], manifold.depth),
    )

    # CCD warp-back: depth(0) = depth(t) + n·(v_a − v_b)·t (t is 0 without CCD).
    vn = manifold.normal.dot(state.vel[a] - state.vel[b])
    manifold = manifold._replace(depth=manifold.depth + (vn * cp.t)[:, None])
    rel_speed = (state.vel[a] - state.vel[b]).length()
    pair_min = 0.5 * (state.spec_margin_min[a] + state.spec_margin_min[b])
    pair_max = torch.minimum(state.spec_margin_max[a], state.spec_margin_max[b])
    margin = torch.clamp(rel_speed * dt + pair_min, min=torch.zeros_like(pair_min),
                         max=torch.maximum(pair_min, pair_max))
    contact_ok = (cp.valid[:, None] & front[:, None] & manifold.contact_mask
                  & (manifold.depth > -margin[:, None]))
    record_valid = cp.valid & front & contact_ok.any(dim=-1)

    prestep = ContactPrestep(
        body_a=cp.body_a,
        body_b=cp.body_b,
        normal=manifold.normal,
        offset_a=manifold.offset_a,
        offset_b=state.pos[b] - state.pos[a],
        depth=manifold.depth,
        contact_mask=contact_ok,
        valid=record_valid,
        friction=torch.sqrt(state.friction[a] * state.friction[b]),
        spring=SpringSettings.make(torch.minimum(state.spring_frequency[a], state.spring_frequency[b]),
                                   torch.maximum(state.spring_damping[a], state.spring_damping[b])),
        max_recovery_velocity=torch.minimum(state.max_recovery_velocity[a],
                                            state.max_recovery_velocity[b]),
        feature=manifold.feature,
    )
    # Composite key = pair_key · sub_cap + child slot (int32; NB² · sub_cap < 2³¹).
    key = pair_key(cp.body_a, cp.body_b, n_bodies) * sub_cap + sub
    imp, carried_color = _warm_start_from_cache_keyed(prestep, cache, key, sleep_bank=sleep_bank)
    return prestep, imp, carried_color, key, cp.overflow


def _warm_start_from_cache_keyed(prestep: ContactPrestep, cache: PairCache, key,
                                 presorted: bool = False, sleep_bank: PairCache = None):
    """Keyed cache carry: sorted-key lookup, then feature-id impulse redistribution
    (reference NarrowPhaseConstraintUpdate, PairCache.cs:78). Pairs missing from the
    active cache match against ``sleep_bank`` (reference PairCache_Activity); the JAX
    package skips that join when the bank holds no row, and then it matches nothing, so
    the port always runs it. Returns (impulses, carried colors)."""
    if presorted:
        sorted_keys, sort_idx = cache.key, None
    else:
        sorted_keys, sort_idx = torch.sort(cache.key, stable=True)
    pos_c = torch.searchsorted(sorted_keys, key).clamp_max(sorted_keys.shape[0] - 1)
    hit_slot = pos_c if sort_idx is None else sort_idx[pos_c]
    hit = gather_rows(dict(feature=cache.feature, penetration=cache.penetration,
                           tx=cache.tangent.x, ty=cache.tangent.y, twist=cache.twist,
                           valid=cache.valid, color=cache.color), hit_slot)
    matched = (sorted_keys[pos_c] == key) & prestep.valid & hit["valid"]

    if sleep_bank is not None:
        spos_c = torch.searchsorted(sleep_bank.key, key).clamp_max(sleep_bank.key.shape[0] - 1)
        shit = gather_rows(dict(feature=sleep_bank.feature, penetration=sleep_bank.penetration,
                                tx=sleep_bank.tangent.x, ty=sleep_bank.tangent.y,
                                twist=sleep_bank.twist, valid=sleep_bank.valid), spos_c)
        # Colors do not survive sleep: the slept pair's (body, color) slots may have been
        # claimed meanwhile, so a woken record re-proposes (-1).
        shit["color"] = torch.full_like(hit["color"], -1)
        smatched = (sleep_bank.key[spos_c] == key) & prestep.valid & shit["valid"] & ~matched
        hit = {k: torch.where(smatched.reshape((-1,) + (1,) * (v.dim() - 1)), shit[k], v)
               for k, v in hit.items()}
        matched = matched | smatched

    eq = (prestep.feature[:, :, None] == hit["feature"][:, None, :]) & prestep.contact_mask[:, :, None]
    pen = torch.where(eq, hit["penetration"][:, None, :], 0.0).sum(dim=-1)
    pen = torch.where(matched[:, None], pen, 0.0)
    tangent = Vec2(torch.where(matched, hit["tx"], 0.0), torch.where(matched, hit["ty"], 0.0))
    twist = torch.where(matched, hit["twist"], 0.0)
    return ContactImpulses(pen, tangent, twist), torch.where(matched, hit["color"], -1)


def update_cache_keyed(prestep: ContactPrestep, imp: ContactImpulses, key, color) -> PairCache:
    return PairCache(
        key=torch.where(prestep.valid, key, _BIG).to(torch.int32),
        feature=prestep.feature,
        penetration=imp.penetration,
        tangent=imp.tangent,
        twist=imp.twist,
        valid=prestep.valid,
        color=color,
        body_a=prestep.body_a,
        body_b=prestep.body_b,
    )


def retain_sleeping(sleep_bank: PairCache, new_cache: PairCache, kind, awake, n_bodies: int,
                    sub_cap: int = 1):
    """End-of-step migration of contact records into and out of the sleep bank
    (reference PairCache_Activity.cs): a bank row stays while its pair is frozen (no
    awake dynamic endpoint) and was not re-absorbed into the active cache; active rows
    whose pairs froze this step join it. The merged set compacts into the bank capacity
    in ascending key order. Returns (bank, overflow)."""
    S = sleep_bank.key.shape[0]
    active_dyn = (kind == KIND_DYNAMIC) & awake

    def frozen_of(key, live):
        pk = torch.div(key, sub_cap, rounding_mode="floor")
        a = torch.remainder(pk, n_bodies).clamp(0, n_bodies - 1).long()
        b = torch.div(pk, n_bodies, rounding_mode="floor").clamp(0, n_bodies - 1).long()
        exists = (kind[a] != 0) & (kind[b] != 0)
        return live & exists & ~(active_dyn[a] | active_dyn[b])

    sorted_new = torch.sort(torch.where(new_cache.valid, new_cache.key, _BIG)).values
    pos = torch.searchsorted(sorted_new, sleep_bank.key).clamp_max(sorted_new.shape[0] - 1)
    in_new = sorted_new[pos] == sleep_bank.key

    frozen_bank = frozen_of(sleep_bank.key, sleep_bank.valid)
    # Wake grace: the bank's color field counts unfrozen frames (colors never survive
    # sleep); an unfrozen row not re-absorbed survives one frame.
    grace = sleep_bank.valid & ~in_new & ~frozen_bank & (sleep_bank.color < 1)
    keep = (frozen_bank & ~in_new) | grace
    add = frozen_of(new_cache.key, new_cache.valid)

    age_bank = torch.where(frozen_bank, -1, sleep_bank.color + 1).to(torch.int32)
    merged = _tree_map2(lambda s, n: torch.cat([s, n]), sleep_bank._replace(color=age_bank),
                        new_cache._replace(color=torch.full_like(new_cache.color, -1)))
    sel, count = compact_true(torch.cat([keep, add]), S)
    live_out = torch.arange(S, device=sel.device) < count
    bank = gather_rows(merged, sel.long())
    bank = bank._replace(key=torch.where(live_out, bank.key, _BIG).to(torch.int32),
                         valid=live_out & bank.valid)
    # compact_true selects in concatenation order; one sort restores ascending keys.
    return gather_rows(bank, torch.sort(bank.key, stable=True).indices), count > S


def retain_sleeping_when(pred, sleep_bank: PairCache, new_cache: PairCache, kind, awake,
                         n_bodies: int, sub_cap: int = 1):
    """``retain_sleeping`` where ``pred`` holds, the bank unchanged (and no overflow)
    where it does not: the JAX package's ``lax.cond`` without a host sync."""
    bank, ovf = retain_sleeping(sleep_bank, new_cache, kind, awake, n_bodies, sub_cap)
    bank = _tree_map2(lambda new, old: torch.where(
        pred.reshape((1,) * new.dim()), new, old), bank, sleep_bank)
    return bank, pred & ovf
