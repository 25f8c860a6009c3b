"""The port's generic convex narrow phase (``collision/convex.py``) and triangle testers
against the JAX package's, function against function on the same numpy inputs (seed 0);
``tests/test_torch_shapes.py`` holds the new shapes, their bounds and the quickhull.

- Within 1e-5 (the same float32 formulas, one pass each): ``support_core`` for every
  type (a hull above 64 vertices included), ``minkowski_support``,
  ``_closest_on_simplex`` and the three triangle testers.
- Within 1e-4 on depth, normal and offsets, with equal contact masks and feature ids:
  ``gjk_closest``, ``mpr_penetration`` and ``generic_convex_manifold``, 256 pairs per
  family (cylinder with sphere, capsule, box and cylinder; hull with box, capsule and
  hull; a custom ellipsoid with box), separated and penetrating. These iterate 24 times
  with convergence masks, and XLA's CPU backend contracts into FMAs where the port
  rounds every op, hence the wider bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.collision import convex as jconvex
from bepuphysics2_tpu.collision import testers as jtesters
from bepuphysics2_tpu.shapes import custom as jcustom
from bepuphysics2_tpu.shapes import registry as jreg
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Vec3 as JVec3

from bepuphysics2_tpu_torch.collision import convex, testers
from bepuphysics2_tpu_torch.interop import shapes_from_numpy
from bepuphysics2_tpu_torch.shapes import custom as tcustom
from bepuphysics2_tpu_torch.shapes import registry as treg
from bepuphysics2_tpu_torch.utils.vec import Quat, Vec3

N = 256  # pairs per family
TIGHT, ITER = 1e-5, 1e-4
FAMILIES = {  # name: (type A, type B), canonical order A <= B
    "sphere-cylinder": ("sphere", "cylinder"),
    "capsule-cylinder": ("capsule", "cylinder"),
    "box-cylinder": ("box", "cylinder"),
    "cylinder-cylinder": ("cylinder", "cylinder"),
    "box-hull": ("box", "hull"),
    "capsule-hull": ("capsule", "hull"),
    "hull-hull": ("hull", "hull"),
    "box-ellipsoid": ("box", "ellipsoid"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one torch thread runs them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_ellipsoid(params, d):
    """Support of the ellipsoid with semi-axes params[..., 0:3]: (a²dx, b²dy, c²dz) /
    |(a dx, b dy, c dz)|, no margin."""
    a, b, c = params[..., 0], params[..., 1], params[..., 2]
    nx, ny, nz = a * d.x, b * d.y, c * d.z
    inv = 1.0 / jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    return JVec3(a * a * d.x * inv, b * b * d.y * inv, c * c * d.z * inv), jnp.zeros_like(a)


def _torch_ellipsoid(params, d):
    a, b, c = params[..., 0], params[..., 1], params[..., 2]
    nx, ny, nz = a * d.x, b * d.y, c * d.z
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz).clamp_min(1e-12)
    return Vec3(a * a * d.x * inv, b * b * d.y * inv, c * c * d.z * inv), torch.zeros_like(a)


@pytest.fixture(scope="module")
def ellipsoid():
    """The ellipsoid registered in both packages under one type id."""
    tid = jcustom.register_custom_shape(_jax_ellipsoid, name="ellipsoid")
    tcustom.register_custom_shape(_torch_ellipsoid, name="ellipsoid", type_id=tid)
    yield tid
    jcustom.CUSTOM_SUPPORTS.pop(tid)
    tcustom.CUSTOM_SUPPORTS.pop(tid)


def _sphere_points(rng, n, r):
    p = rng.normal(size=(n, 3))
    return r * p / np.linalg.norm(p, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def scene(ellipsoid):
    """Both registries with one shape of each type (two hulls: 24 points, and 120 points
    whose hull has more than 64 vertices), their device data, and the shape rows."""
    rng = np.random.default_rng(0)
    pts24, pts120 = _sphere_points(rng, 24, 0.5), _sphere_points(rng, 120, 0.6)
    jr, tr = jreg.ShapeRegistry(16), treg.ShapeRegistry(16)
    rows = {}
    for mod, reg in ((jreg, jr), (treg, tr)):
        custom = (jcustom if mod is jreg else tcustom).CustomShape
        shapes = dict(
            sphere=mod.Sphere(0.45), capsule=mod.Capsule(0.3, 0.4), box=mod.Box(0.5, 0.35, 0.4),
            cylinder=mod.Cylinder(0.5, 0.4), hull=mod.ConvexHull.from_points(pts24),
            hull120=mod.ConvexHull.from_points(pts120),
            triangle=mod.Triangle((-0.6, 0.0, -0.4), (0.7, 0.1, -0.3), (0.0, -0.1, 0.8)),
            ellipsoid=custom(ellipsoid, params=(0.6, 0.3, 0.4), max_radius=0.6))
        rows[mod.__name__] = {k: reg.add(s) for k, s in shapes.items()}
    assert rows[jreg.__name__] == rows[treg.__name__]
    assert len(tr.shapes[rows[treg.__name__]["hull120"]].points) > 64
    jshapes = jr.device()
    return dict(rows=rows[treg.__name__], jshapes=jshapes,
                tshapes=shapes_from_numpy(jax.tree_util.tree_map(np.asarray, jshapes), "cpu"),
                ellipsoid=ellipsoid)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _v(mod, a):
    cls = JVec3 if mod == "jax" else Vec3
    conv = jnp.asarray if mod == "jax" else torch.from_numpy
    return cls(*(conv(np.ascontiguousarray(a[..., i])) for i in range(3)))


def _q(mod, a):
    cls = JQuat if mod == "jax" else Quat
    conv = jnp.asarray if mod == "jax" else torch.from_numpy
    return cls(*(conv(np.ascontiguousarray(a[..., i])) for i in range(4)))


def _close(got, want, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _vclose(got, want, tol, what):
    for c in "xyz":
        _close(getattr(got, c), getattr(want, c), tol, f"{what}.{c}")


# ---- supports and the simplex -----------------------------------------------------------


def _records(scene, types, n, rng):
    """``n`` records of the named shapes: (type ids, params, hull starts, counts) as numpy,
    the port's hull rows, and the shape rows."""
    shapes = scene["jshapes"]
    rows = np.array([scene["rows"][t] for t in types], np.int32)[rng.integers(0, len(types), n)]
    tid = np.asarray(shapes.type)[rows]
    params = np.asarray(shapes.params)[rows]
    start, count = np.asarray(shapes.hull_start)[rows], np.asarray(shapes.hull_count)[rows]
    return (tid, params, start, count, scene["tshapes"].hull_rows[torch.from_numpy(rows).long()],
            rows)


def _jpool(scene):
    s = scene["jshapes"]
    return JVec3(s.hull_x, s.hull_y, s.hull_z), s.hull_win.shape[0]


def _tpool(scene):
    s = scene["tshapes"]
    return Vec3(s.hull_x, s.hull_y, s.hull_z)


def test_support_core_matches_jax_for_every_type(scene):
    rng = np.random.default_rng(0)
    n = 1024
    tid, params, start, count, trows, _ = _records(scene, list(scene["rows"]), n, rng)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    pool, n_win = _jpool(scene)
    wp, wm = jax.jit(lambda t, p, s, c, dx, dy, dz: jconvex.support_core(
        t, p, pool, s, c, JVec3(dx, dy, dz), n_win=n_win))(tid, params, start, count,
                                                          *d.T.copy())
    gp, gm = convex.support_core(torch.from_numpy(tid), torch.from_numpy(params), _tpool(scene),
                                 trows, _v("t", d))
    _vclose(gp, wp, TIGHT, "support point")
    _close(gm, wm, TIGHT, "margin")
    assert set(np.unique(tid)) >= {0, 1, 2, 3, 4, 5, scene["ellipsoid"]}


def _ctx(scene, fam, n, rng):
    """One family's ``n`` pair records in both packages: (JAX args, port SupportCtx,
    orn_a). B's centre lies at 0.3-1.3 times the sum of the two bounding radii from A's,
    so that about half the pairs penetrate."""
    ta, tb = FAMILIES[fam]
    a = _records(scene, [ta] if ta != "hull" else ["hull", "hull120"], n, rng)
    b = _records(scene, [tb] if tb != "hull" else ["hull", "hull120"], n, rng)
    radius = np.asarray(scene["jshapes"].max_radius)
    reach = radius[a[5]] + radius[b[5]]
    direction = _sphere_points(rng, n, 1.0)
    dist = reach * rng.uniform(0.3, 1.3, n)
    pos_ab = (direction * dist[:, None]).astype(np.float32)
    orn_ab, orn_a = _quats(rng, n), _quats(rng, n)
    pool, n_win = _jpool(scene)
    jargs = (a[0], a[1], b[0], b[1], orn_ab, pos_ab, a[2], a[3], b[2], b[3])
    tctx = convex.SupportCtx(
        type_a=torch.from_numpy(a[0]), params_a=torch.from_numpy(a[1]),
        type_b=torch.from_numpy(b[0]), params_b=torch.from_numpy(b[1]),
        orn_ab=_q("t", orn_ab), pos_ab=_v("t", pos_ab), hull_points=_tpool(scene),
        hull_rows_a=a[4], hull_rows_b=b[4])
    return jargs, tctx, orn_a


def _jctx(scene, args):
    pool, n_win = _jpool(scene)
    ta, pa, tb, pb, orn_ab, pos_ab, sa, ca, sb, cb = args
    return jconvex.SupportCtx(ta, pa, tb, pb, JQuat(*orn_ab), JVec3(*pos_ab), pool, sa, ca,
                              sb, cb, hull_windows=n_win)


def _jargs(args):
    ta, pa, tb, pb, orn_ab, pos_ab, sa, ca, sb, cb = args
    return (ta, pa, tb, pb, orn_ab.T.copy(), pos_ab.T.copy(), sa, ca, sb, cb)


def test_minkowski_support_matches_jax(scene):
    rng = np.random.default_rng(0)
    for fam in FAMILIES:
        args, tctx, _ = _ctx(scene, fam, N, rng)
        d = rng.normal(size=(N, 3)).astype(np.float32)
        want = jax.jit(lambda a, dd: jconvex.minkowski_support(_jctx(scene, a), JVec3(*dd)))(
            _jargs(args), d.T.copy())
        got = convex.minkowski_support(tctx, _v("t", d))
        _vclose(got[0], want[0], TIGHT, f"{fam} w")
        _vclose(got[1], want[1], TIGHT, f"{fam} point on A")
        _close(got[2], want[2], TIGHT, f"{fam} margin")


def test_closest_on_simplex_matches_jax():
    rng = np.random.default_rng(0)
    n = 2048
    pts = rng.normal(size=(4, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(n, 4)) < 0.75
    mask[:, 0] = True
    want = jax.jit(lambda p, m: jconvex._closest_on_simplex([JVec3(*q.T) for q in p], m))(
        pts, mask)
    got = convex._closest_on_simplex([_v("t", q) for q in pts], torch.from_numpy(mask))
    _vclose(got[0], want[0], TIGHT, "closest")
    _close(got[1], want[1], TIGHT, "barycentric")
    _close(got[2], want[2], 0, "kept")


# ---- GJK, MPR, the generic manifold and the triangle testers ------------------------------
#
# Some of these outputs are ill-conditioned or not unique at some inputs, in both packages:
# - GJK and MPR stop at the first iteration whose progress falls under a threshold, so
#   one ulp can stop one side an iteration before the other; on a curved surface, where
#   24 iterations do not converge, the two then differ by that iteration's residual (up
#   to ~3e-2), and MPR's portal choices flip under float32 noise. GJK's result means
#   something only for a separated pair and MPR's only for a penetrating one.
# - A face contact has no unique point on A (MPR's portal and GJK's simplex on a hull's
#   face pick among coplanar vertices whose support dots tie to the last bit), and the
#   manifold's extra contacts, their order and feature ids turn on depth gates and exact
#   ties (coplanar faces, a vertex shared by two edges).
# So a record's unique outputs (GJK's distance, MPR's core depth, normal and margin of
# either; a manifold's normal and deepest depth) are held to JAX's within the bound where
# the record lies in the function's domain and is stable in the JAX package: its unique
# outputs move by at most a tenth of the bound when B's offset is nudged by ±1e-7 and
# ±3e-7 relative (float32 noise), so that rounding cannot account for a miss. The port
# must be stable under the same nudges on as many of those records as the JAX package is
# on the port's stable ones, give or take n/64: it is held on the rest, and a port that is
# ill-conditioned where the reference is not fails. Each function must hold at least four
# fifths of the records it held at seed 0 in each family (``MIN_HELD``), and on most held
# records the outputs that are one choice among several (points on A; a manifold's
# contact mask, feature ids, depths and offsets) must be JAX's too. ROADMAP queue 3 gives
# the shares, and ``tools/gjk_parting.py`` the iteration where each pair beyond the bound
# parts.
NUDGES = (1e-7, -1e-7, 3e-7, -3e-7)
MIN_SAME_CHOICE = 0.6  # the least share of held records that make every choice as JAX
# The least held records per family (GJK, MPR, manifold): four fifths of those held with
# seed 0 (203, 20, 223; 64, 18, 82; 52, 61, 114; 19, 39, 58; 99, 151, 251; 197, 50, 248;
# 89, 163, 252; 43, 28, 75 of 256, in FAMILIES' order).
MIN_HELD = {
    "sphere-cylinder": (162, 16, 178), "capsule-cylinder": (51, 14, 65),
    "box-cylinder": (41, 48, 91), "cylinder-cylinder": (15, 31, 46),
    "box-hull": (79, 120, 200), "capsule-hull": (157, 40, 198), "hull-hull": (71, 130, 201),
    "box-ellipsoid": (34, 22, 60),
}


def _nudged(pos: Vec3, e):
    return Vec3(pos.x * (1 + e), pos.y * (1 - e), pos.z * (1 + e))


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _cols(v):
    v = np.stack([np.asarray(c) for c in v], -1) if isinstance(v, tuple) else np.asarray(v)
    return v.reshape(v.shape[0], -1)


def _split(out):
    """(unique, chosen): per record, lists of (n, k) arrays of an output's unique values and
    of the values that are one valid choice among several. GJK and MPR: (distance or core
    depth, normal, margin) and (point on A). A manifold: (normal, deepest live depth) and
    (contact mask, then feature ids, depths and offsets of the live contacts)."""
    if hasattr(out, "contact_mask"):
        live = np.asarray(out.contact_mask)
        deepest = np.where(live, np.asarray(out.depth), -np.inf).max(1)
        chosen = [live, np.where(live, out.feature, -1), np.where(live, out.depth, 0.0)]
        chosen += [np.where(live, c, 0.0) for c in out.offset_a]
        return [_cols(out.normal), _cols(deepest)], [_cols(c) for c in chosen]
    return [_cols(out[0]), _cols(out[1]), _cols(out[3])], [_cols(out[2])]


def _gap(a, b):
    """Per record: the largest difference of the arrays (inf where integers differ)."""
    gap = np.zeros(a[0].shape[0])
    for x, y in zip(a, b):
        d = (np.abs(x.astype(np.float64) - y) if x.dtype.kind == "f"
             else np.where(x == y, 0.0, np.inf))
        gap = np.maximum(gap, d.max(1))
    return gap


def _noise(out, nudged):
    """Per record: how far the nudges move the unique outputs."""
    u = _split(_numpy(out))[0]
    return np.max([_gap(u, _split(_numpy(o))[0]) for o in nudged], 0)


def _hold(got, nudged, want, want_nudged, tol, what, domain=None, min_held=None):
    """Held records: in ``domain`` and moved by at most tol/10 by the JAX package's own
    nudges. The port may be the noisier on no more records than the JAX package is, plus
    n/64 (a port that is ill-conditioned where the reference is not fails here instead of
    dropping its records); every held record on which the port is stable too has its
    unique outputs within ``tol`` of ``want``'s; at least ``min_held`` (default n/16)
    records are held, and most make JAX's choices. Returns the held mask."""
    gu, gc = _split(_numpy(got))
    wu, wc = _split(_numpy(want))
    n = gu[0].shape[0]
    domain = np.ones(n, bool) if domain is None else domain
    port_noisy = _noise(got, nudged) > tol / 10
    jax_noisy = _noise(want, want_nudged) > tol / 10
    held = domain & ~jax_noisy
    port_only, jax_only = (held & port_noisy).sum(), (domain & jax_noisy & ~port_noisy).sum()
    assert port_only <= jax_only + n // 64, (
        f"{what}: the port is noisy on {port_only} records the JAX package is stable on, "
        f"the JAX package on {jax_only} the other way")
    gap = _gap(gu, wu)
    bad = np.nonzero(held & ~port_noisy & (gap > tol))[0]
    assert bad.size == 0, f"{what}: held records {bad.tolist()} differ by {gap[bad].tolist()}"
    need = n // 16 if min_held is None else min_held
    assert held.sum() >= need, f"{what}: only {held.sum()} of {n} records held (least {need})"
    same = (_gap(gc, wc) <= tol)[held & ~port_noisy].mean()
    assert same >= MIN_SAME_CHOICE, f"{what}: {same:.3f} of held records make JAX's choices"
    return held & ~port_noisy


@pytest.fixture(scope="module")
def iterated(scene):
    """gjk_closest, mpr_penetration and generic_convex_manifold of every family in both
    packages (one JAX compile each, over all families at once), and the port's under each
    nudge of B's offset."""
    rng = np.random.default_rng(0)
    per = {fam: _ctx(scene, fam, N, rng) for fam in FAMILIES}
    cat = lambda i: np.concatenate([per[f][0][i] for f in FAMILIES])
    jall = tuple(cat(i) for i in range(10))
    orn_a = np.concatenate([per[f][2] for f in FAMILIES])
    fns = dict(gjk=lambda a, q: jconvex.gjk_closest(_jctx(scene, a)),
               mpr=lambda a, q: jconvex.mpr_penetration(_jctx(scene, a)),
               manifold=lambda a, q: jconvex.generic_convex_manifold(_jctx(scene, a), JQuat(*q)))
    jits = {k: jax.jit(fn) for k, fn in fns.items()}
    jax_at = lambda args: {k: jax.tree_util.tree_map(np.asarray, f(_jargs(args), orn_a.T.copy()))
                           for k, f in jits.items()}
    want = jax_at(jall)
    pos = jall[5]
    want_nudged = [jax_at(jall[:5] + (pos * np.float32([1 + e, 1 - e, 1 + e]),) + jall[6:])
                   for e in NUDGES]
    tcat = lambda f: torch.cat([getattr(per[fam][1], f) for fam in FAMILIES])
    tctx = convex.SupportCtx(
        type_a=tcat("type_a"), params_a=tcat("params_a"), type_b=tcat("type_b"),
        params_b=tcat("params_b"),
        orn_ab=Quat(*(torch.cat([getattr(per[f][1].orn_ab, c) for f in FAMILIES]) for c in "xyzw")),
        pos_ab=Vec3(*(torch.cat([getattr(per[f][1].pos_ab, c) for f in FAMILIES]) for c in "xyz")),
        hull_points=_tpool(scene),
        hull_rows_a=torch.cat([per[f][1].hull_rows_a for f in FAMILIES]),
        hull_rows_b=torch.cat([per[f][1].hull_rows_b for f in FAMILIES]))
    port = lambda c: dict(gjk=convex.gjk_closest(c), mpr=convex.mpr_penetration(c),
                          manifold=convex.generic_convex_manifold(c, _q("t", orn_a)))
    got = port(tctx)
    nudged = [port(tctx._replace(pos_ab=_nudged(tctx.pos_ab, e))) for e in NUDGES]
    return want, want_nudged, got, nudged


def _fam(x, k):
    s = slice(k * N, (k + 1) * N)
    if hasattr(x, "_fields"):
        return type(x)(*(_fam(v, k) for v in x))
    if isinstance(x, tuple):
        return tuple(_fam(v, k) for v in x)
    return x[s]


@pytest.mark.parametrize("fn", ["gjk", "mpr", "manifold"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_iterated_narrow_phase_matches_jax(iterated, fam, fn):
    """GJK, MPR and the generic manifold within 1e-4 of JAX's on every held record."""
    k = list(FAMILIES).index(fam)
    want, want_nudged, got, nudged = iterated
    w = _fam(want[fn], k)
    # GJK's domain: separated pairs; MPR's: penetrating ones; the manifold's: all.
    domain = dict(gjk=np.asarray(w[0]) > 1e-3, mpr=np.asarray(w[0]) > 0.0).get(fn)
    held = _hold(_fam(got[fn], k), [_fam(o[fn], k) for o in nudged], w,
                 [_fam(o[fn], k) for o in want_nudged], ITER, f"{fam} {fn}", domain,
                 MIN_HELD[fam][("gjk", "mpr", "manifold").index(fn)])
    if fn == "manifold":
        assert np.asarray(w.contact_mask)[held][:, 1:].any()  # the tilted samples add contacts


@pytest.mark.parametrize("tester", ["sphere_triangle", "capsule_triangle", "box_triangle"])
def test_triangle_tester_matches_jax(tester):
    """Each triangle tester within 1e-5 of JAX's on every held record (one pass of the
    same formulas, so the tighter bound)."""
    rng = np.random.default_rng(0)
    n = 1024
    tri = rng.uniform(-1.0, 1.0, (n, 9)).astype(np.float32)
    params_a = {"sphere_triangle": np.c_[rng.uniform(0.2, 0.6, n)],
                "capsule_triangle": np.c_[rng.uniform(0.1, 0.4, n), rng.uniform(0.1, 0.6, n)],
                "box_triangle": rng.uniform(0.2, 0.6, (n, 3))}[tester]
    params_a = np.pad(params_a, ((0, 0), (0, 12 - params_a.shape[1]))).astype(np.float32)
    params_b = np.pad(tri, ((0, 0), (0, 3)))
    pos_ab = (_sphere_points(rng, n, 1.0) * rng.uniform(0.0, 1.2, (n, 1))).astype(np.float32)
    orn_a, orn_b = _quats(rng, n), _quats(rng, n)
    jfn, tfn = getattr(jtesters, tester), getattr(testers, tester)
    pa, pb = torch.from_numpy(params_a), torch.from_numpy(params_b)
    if tester == "sphere_triangle":
        jit = jax.jit(lambda p, qb, a, b: jfn(JVec3(*p), JQuat(*qb), a, b))
        jax_at = lambda pos: jit(pos.T.copy(), orn_b.T.copy(), params_a, params_b)
        port = lambda pos: tfn(_v("t", pos), _q("t", orn_b), pa, pb)
    else:
        jit = jax.jit(lambda p, qa, qb, a, b: jfn(JVec3(*p), JQuat(*qa), JQuat(*qb), a, b))
        jax_at = lambda pos: jit(pos.T.copy(), orn_a.T.copy(), orn_b.T.copy(), params_a, params_b)
        port = lambda pos: tfn(_v("t", pos), _q("t", orn_a), _q("t", orn_b), pa, pb)
    nudge = lambda e: pos_ab * np.float32([1 + e, 1 - e, 1 + e])
    want = jax.tree_util.tree_map(np.asarray, jax_at(pos_ab))
    held = _hold(port(pos_ab), [port(nudge(e)) for e in NUDGES], want,
                 [jax.tree_util.tree_map(np.asarray, jax_at(nudge(e))) for e in NUDGES],
                 TIGHT, tester)
    assert (np.asarray(want.depth)[held][:, 0] > 0).sum() > n // 8
