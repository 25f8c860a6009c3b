"""Narrow phase: type-pair dispatch → manifolds → contact prestep records with row-local
warm-start carry from the pair store.

Counterpart of ``run_convex_testers``, ``convex_pair_records`` and ``narrow_phase_store``
in ``bepuphysics2_tpu/collision/narrowphase.py`` for sphere and box shapes. The port has
no CCD, no compound or mesh path, no generic GJK/MPR fallback and no legacy per-frame
cache path yet (ROADMAP queue 1 items 17-19); a scene that would need them is refused
before it is stepped.
"""
from __future__ import annotations

import torch

from ..bodies import BodyState
from ..constraints.contact import ContactImpulses, ContactPrestep
from ..shapes.registry import BOX, SPHERE, ShapeData
from ..utils.spring import SpringSettings
from ..utils.vec import Quat, Vec2, Vec3
from . import testers
from .manifold import Manifold


def _sphere_sphere(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_sphere(pos_ab, pa, pb)


def _sphere_box(pos_ab, orn_a, orn_b, pa, pb):
    return testers.sphere_box(pos_ab, orn_b, pa, pb)


def _box_box(pos_ab, orn_a, orn_b, pa, pb):
    return testers.box_box(pos_ab, orn_a, orn_b, pa, pb)


# Registered convex type-pair testers (canonical order: type_a <= type_b).
TESTER_REGISTRY = [
    (SPHERE, SPHERE, _sphere_sphere),
    (SPHERE, BOX, _sphere_box),
    (BOX, BOX, _box_box),
]


def run_convex_testers(
    shapes: ShapeData,
    ti, tj, params_i, params_j, pos_i, pos_j, orn_i, orn_j, shape_i, shape_j,
    valid, present_types=None, include_triangles=False,
) -> Manifold:
    """Run the analytic testers over canonical (type_i ≤ type_j) pair records. Returns a
    manifold relative to the i-side pose. ``shapes``, ``shape_i/j`` and
    ``include_triangles`` are kept for the JAX signature (the generic fallback and the
    triangle families that read them are not ported)."""
    mp = ti.shape[0]
    pos_ij = pos_j - pos_i
    manifold = Manifold.empty(mp, device=ti.device)
    present = set(present_types) if present_types is not None else None
    for t0, t1, fn in TESTER_REGISTRY:
        if present is not None and (t0 not in present or t1 not in present):
            continue  # this type pair cannot occur in the scene
        m = fn(pos_ij, orn_i, orn_j, params_i, params_j)
        manifold = m.where(valid & (ti == t0) & (tj == t1), manifold)
    return manifold


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
    Returns (prestep, t_eval); t_eval is None (CCD is not ported)."""
    if max_ccd > 0:
        raise NotImplementedError("CCD is not ported yet (ROADMAP queue 1 item 19)")
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

    manifold = run_convex_testers(
        shapes, ti, tj, params_i, params_j, pos_i, pos_j, orn_i, orn_j,
        shape_i, shape_j, valid, present_types,
    )
    # Un-flip swapped pairs: offsets relative to scene body a, normal from b to a.
    manifold = manifold.flipped(pos_i - pos_j).where(swap, manifold)

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
    return prestep, None


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
