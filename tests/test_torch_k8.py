"""Kernel K8, the conservative advancement (``csrc/conservative_advance.cu``), and its plain
version ``collision/sweeps.py`` ``_advance``, on the same seeded records (numpy, seed 0):
256 per pair of the six built-in convex types (sphere, capsule, box, triangle, cylinder,
convex hull; 21 pairs), and 128 per pair against the children of a compound (spheres,
boxes) and of a mesh (capsules, hulls), at the children's local poses.

- On the CPU, ``_advance`` against the JAX package's advancement loop at the sweep's 32
  iterations: the body of JAX ``sweep_shape_all``'s ``fori_loop`` (and ``pair_toi``'s,
  the same loop) over the same records, built from JAX ``gjk_closest`` and
  ``integrate_orientation``. GJK is ill-conditioned in both packages (ROADMAP queue 3:
  one ulp can stop it an iteration early, which moves an impact by one advancement
  step), so the stable-record rule of ``tests/test_torch_sweeps.py`` holds: ``t`` within
  1e-4 on the records whose JAX result moves by at most 1e-5 when every position and
  angular velocity is scaled by 1 + 1e-7 (at least four in five). One nudge samples the
  conditioning once, so a few records it calls stable still part: at most one in 256,
  printed (flat contacts, box on box, where XLA's fused multiply-adds stop GJK an
  iteration from the port's).
- On the CPU, K8's plain version over its tables (``draw_tables``: a sweep of each type
  against bodies of each type, a compound's children and mesh triangles; the product of
  the two tables and an explicit pair list with its own ``exists``) bit for bit against
  ``_advance`` on the flat records that the wrapper before the tables built from the same
  rows (``parent_flat``), at 32 iterations and at CCD's 12 with its miss rule; and K8's
  CUDA source built for the host with g++ (``tools/k8_host_check.py``) bit for bit
  against its plain version on those tables and on ``draw_spinning``'s records.
- On the card (``cuda``), K8 against its plain version on the same records, at 32
  iterations (a miss gives 3e38) and at 12 (a miss gives the record's ``max_t``, as
  ``pair_toi`` takes it): K8 is built with ``-fmad=false`` and rounds each operation as
  the plain version's PyTorch op does, so every record is bit for bit equal, in both
  forms, on records that run 32 advancement iterations of 24 GJK iterations each, and
  on a repeat.

JAX is imported inside the CPU test, so the file runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_k8.py -q
"""
import os
import sys

import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch.collision import sweeps
from bepuphysics2_tpu_torch.shapes import registry as treg
from bepuphysics2_tpu_torch.utils.vec import Quat, Vec3

N = 256  # records per family
TOL, STABLE, NUDGE = 1e-4, 1e-5, 1e-7
TYPES = ("sphere", "capsule", "box", "triangle", "cylinder", "hull")
MAX_T = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_registry(reg_mod):
    """One shape of each built-in type, a compound of four of them and a 6 x 6-cell mesh,
    in ``reg_mod``'s registry (the JAX package's or the port's). Returns (registry, rows)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(24, 3))
    reg = reg_mod.ShapeRegistry(16)
    shapes = dict(
        sphere=reg_mod.Sphere(0.45), capsule=reg_mod.Capsule(0.3, 0.4),
        box=reg_mod.Box(0.5, 0.35, 0.4),
        triangle=reg_mod.Triangle((-0.6, 0.0, -0.4), (0.7, 0.1, -0.3), (0.0, -0.1, 0.8)),
        cylinder=reg_mod.Cylinder(0.5, 0.4),
        hull=reg_mod.ConvexHull.from_points(0.5 * pts / np.linalg.norm(pts, axis=1)[:, None]))
    rows = {k: reg.add(s) for k, s in shapes.items()}
    rows["compound"] = reg.add(reg_mod.Compound.build([
        (rows["sphere"], (-1.0, 0.0, 0.0)), (rows["box"], (1.0, 0.0, 0.0)),
        (rows["capsule"], (0.0, 0.8, 0.0), (0.0, 0.0, 0.3826834, 0.9238795)),
        (rows["hull"], (0.0, -0.8, 0.0))]))
    tris = []
    for i in range(6):
        for j in range(6):
            y = lambda a, b: 0.3 * np.sin(a) * np.cos(b)
            v = [(i, y(i, j), j), (i, y(i, j + 1), j + 1), (i + 1, y(i + 1, j), j),
                 (i + 1, y(i + 1, j + 1), j + 1)]
            tris += [(v[0], v[1], v[2]), (v[2], v[1], v[3])]
    rows["mesh"] = reg.add(reg_mod.Mesh.build([[tuple(float(c) for c in p) for p in t]
                                               for t in tris]))
    return reg, rows


def _unit(rng, n):
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def draw_records(shapes, rows, n=N, seed=0):
    """The records, as numpy (``shapes``: a ShapeData of numpy leaves). A is a shape of its
    type; B a shape of its type at identity local pose, or a child of the compound or the
    mesh at the child's local pose. A starts 0.8-3 bounding radii from B and heads toward it
    (or past it), both spinning, so that about half the records hit within ``MAX_T``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    fams = [(a, b) for i, a in enumerate(TYPES) for b in TYPES[i:]]
    fams += [(a, "compound") for a in ("sphere", "box")] + [(a, "mesh") for a in ("capsule",
                                                                               "hull")]
    ra, rb, child, fam = [], [], [], []
    for k, (a, b) in enumerate(fams):
        m = n if b not in ("compound", "mesh") else n // 2
        ra += [rows[a]] * m
        rb += [rows[b]] * m
        if b in ("compound", "mesh"):
            s = rows[b]
            child += list(shapes.child_start[s] + rng.integers(0, shapes.child_count[s], m))
        else:
            child += [-1] * m
        fam += [k] * m
    ra, rb, child, fam = (np.asarray(v) for v in (ra, rb, child, fam))
    m = len(ra)
    is_child = child >= 0
    cr = np.maximum(child, 0)
    cs = shapes.child_shape[cr]
    tri = is_child & (cs < 0)
    b_shape = np.where(is_child, np.maximum(cs, 0), rb)
    type_b = np.where(tri, treg.TRIANGLE, shapes.type[b_shape]).astype(np.int32)
    tri12 = np.concatenate([shapes.child_tri[cr], np.zeros((m, 3), f32)], 1)
    params_b = np.where(tri[:, None], tri12, shapes.params[b_shape]).astype(f32)
    lpos = np.where(is_child[:, None], shapes.child_pos[cr], 0.0).astype(f32)
    lorn = np.where(is_child[:, None], shapes.child_orn[cr], [0.0, 0.0, 0.0, 1.0]).astype(f32)
    radius = shapes.max_radius
    r_b = np.where(is_child, np.linalg.norm(np.maximum(np.abs(shapes.child_aabb_min[cr]),
                                                       np.abs(shapes.child_aabb_max[cr])), axis=1),
                   radius[rb])
    reach = radius[ra] + np.where(is_child, 0.8, radius[rb])
    o_pos = rng.normal(size=(m, 3))
    b_world = o_pos + lpos  # roughly: the child's centre
    a_pos = b_world + _unit(rng, m) * (reach * rng.uniform(0.8, 3.0, m))[:, None]
    o_vel = rng.normal(scale=0.3, size=(m, 3))
    a_vel = (b_world - a_pos) * rng.uniform(0.2, 1.5, (m, 1)) + rng.normal(scale=0.3,
                                                                           size=(m, 3))
    a_w, o_w = rng.normal(size=(m, 3)), rng.normal(size=(m, 3))
    r = dict(a_pos=a_pos, a_orn=_quats(rng, m), a_vel=a_vel, a_omega=a_w, o_pos=o_pos,
             o_orn=_quats(rng, m), o_vel=o_vel, o_omega=o_w, lpos=lpos, lorn=lorn)
    r = {k: v.astype(f32) for k, v in r.items()}
    sb = (np.linalg.norm(r["a_vel"] - r["o_vel"], axis=1) + np.linalg.norm(r["a_omega"], axis=1)
          * radius[ra] + np.linalg.norm(r["o_omega"], axis=1) * r_b + 1e-6)
    r.update(
        type_a=shapes.type[ra].astype(np.int32), params_a=shapes.params[ra].astype(f32),
        hs_a=shapes.hull_start[ra], hc_a=shapes.hull_count[ra], row_a=ra,
        type_b=type_b, params_b=params_b,
        hs_b=np.where(tri, 0, shapes.hull_start[b_shape]).astype(np.int32),
        hc_b=np.where(tri, 0, shapes.hull_count[b_shape]).astype(np.int32),
        row_b=np.where(tri, -1, b_shape), r_b=r_b.astype(f32), speed_bound=sb.astype(f32),
        exists=np.ones(m, bool), max_t=np.full(m, MAX_T, f32), family=fam)
    return r


def nudged(r, e):
    """Every position and angular velocity scaled by about an ulp: the orientations at t
    then move by an ulp of sin and cos, where the two packages' sin and cos differ."""
    s = np.float32([1 + e, 1 - e, 1 + e])
    return dict(r, **{k: r[k] * s for k in ("a_pos", "o_pos", "a_omega", "o_omega")})


def port_records(r, shapes, device):
    """``_advance``'s ``x`` from the records (``shapes``: the port's ShapeData)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    v = lambda a: Vec3(*(t(a[:, i]) for i in range(3)))
    q = lambda a: Quat(*(t(a[:, i]) for i in range(4)))
    rows = lambda k: shapes.hull_rows[t(np.maximum(r[k], 0)).long()]
    hull_b = torch.where(t(r["row_b"] < 0)[:, None], -1, rows("row_b"))
    return dict(
        sweep=dict(pos=v(r["a_pos"]), orn=q(r["a_orn"]), vel=v(r["a_vel"]), omega=v(r["a_omega"])),
        type_a=t(r["type_a"]), params_a=t(r["params_a"]), type_b=t(r["type_b"]),
        params_b=t(r["params_b"]), hull_points=Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z),
        hull_a=rows("row_a"), hull_b=hull_b, o_pos=v(r["o_pos"]), o_orn=q(r["o_orn"]),
        o_vel=v(r["o_vel"]), o_omega=v(r["o_omega"]), lpos=v(r["lpos"]), lorn=q(r["lorn"]),
        speed_bound=t(r["speed_bound"]), exists=t(r["exists"]), max_t=t(r["max_t"]))


def records_as_tables(r, shapes, device):
    """The records of ``draw_records`` as K8's tables: record k is A row k against B row k
    (the explicit form), ``max_t`` the records' one value."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    v = lambda k: Vec3(*(t(r[k][:, i]) for i in range(3)))
    q = lambda k: Quat(*(t(r[k][:, i]) for i in range(4)))
    m = r["type_a"].shape[0]
    radius = shapes.max_radius.cpu().numpy()
    a = sweeps.table(v("a_pos"), q("a_orn"), v("a_vel"), v("a_omega"),
                     t(radius[r["row_a"]]), t(r["type_a"]), t(r["params_a"]), t(r["row_a"]))
    b = sweeps.table(v("o_pos"), q("o_orn"), v("o_vel"), v("o_omega"), t(r["r_b"]),
                     t(r["type_b"]), t(r["params_b"]),
                     t(r["row_b"]), None, v("lpos"), q("lorn"))
    pairs = t(np.repeat(np.arange(m, dtype=np.int32)[:, None], 2, 1))
    return sweeps.Records(a, b, pairs, t(r["exists"]), float(r["max_t"][0]), shapes.hull_rows,
                          Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z))


def draw_tables(shapes, rows, form, seed=1, n_sweeps=6):
    """K8's records over two tables (``shapes``: the port's ShapeData, on the records'
    device). B, the targets around the origin, each with its owner's motion: two bodies of
    each built-in type, the compound's four children at their local poses and six
    triangles of the mesh (one body target without ``exists``). A, one sweep of each
    built-in type (a hull's own pool rows; half the others with registry row -1) from 2-4
    m away toward the cluster, spinning. ``form`` "product": every sweep against every
    target; "explicit": 256 (sweep, target) pairs drawn at random, one in eight without
    ``exists``. ``max_t`` is ``MAX_T``."""
    rng = np.random.default_rng(seed)
    dev = shapes.params.device
    sh = type(shapes)(*(x.cpu().numpy() for x in shapes))
    f32 = np.float32
    body_rows = [rows[k] for k in TYPES for _ in range(2)]
    comp, mesh = rows["compound"], rows["mesh"]
    children = list(range(sh.child_start[comp], sh.child_start[comp] + sh.child_count[comp]))
    tris = list(sh.child_start[mesh] + rng.choice(sh.child_count[mesh], 6, replace=False))
    nb_, nc = len(body_rows), len(children) + len(tris)
    t_n = nb_ + nc
    owner_pos = rng.uniform(-1.5, 1.5, (t_n, 3))
    owner_pos[nb_:nb_ + len(children)] = rng.uniform(-0.5, 0.5, 3)  # one compound body
    owner_pos[nb_ + len(children):] = (-3.0, -0.6, -3.0)  # one mesh body
    cr = np.asarray(children + tris)
    cs = sh.child_shape[cr]
    is_tri = cs < 0
    cs_c = np.maximum(cs, 0)
    c_type = np.where(is_tri, treg.TRIANGLE, sh.type[cs_c])
    tri12 = np.concatenate([sh.child_tri[cr], np.zeros((nc, 3), f32)], 1)
    c_params = np.where(is_tri[:, None], tri12, sh.params[cs_c])
    far = np.maximum(np.abs(sh.child_aabb_min[cr]), np.abs(sh.child_aabb_max[cr]))
    b_cols = dict(
        pos=owner_pos, orn=_quats(rng, t_n), vel=rng.normal(scale=0.3, size=(t_n, 3)),
        omega=rng.normal(size=(t_n, 3)),
        radius=np.concatenate([sh.max_radius[body_rows], np.sqrt((far ** 2).sum(1))]),
        type=np.concatenate([sh.type[body_rows], c_type]),
        params=np.concatenate([sh.params[body_rows], c_params]),
        row=np.concatenate([body_rows, np.where(is_tri, -1, cs_c)]),
        exists=np.arange(t_n) != 3,
        lpos=np.concatenate([np.zeros((nb_, 3)), sh.child_pos[cr]]),
        lorn=np.concatenate([np.tile([0.0, 0.0, 0.0, 1.0], (nb_, 1)), sh.child_orn[cr]]))
    a_rows = [rows[TYPES[k % len(TYPES)]] for k in range(n_sweeps)]
    start = _unit(rng, n_sweeps) * rng.uniform(2.0, 4.0, (n_sweeps, 1))
    a_cols = dict(
        pos=start, orn=_quats(rng, n_sweeps),
        vel=-start * rng.uniform(0.6, 1.2, (n_sweeps, 1)) + rng.normal(scale=0.3,
                                                                     size=(n_sweeps, 3)),
        omega=rng.normal(size=(n_sweeps, 3)), radius=sh.max_radius[a_rows],
        type=sh.type[a_rows], params=sh.params[a_rows],
        row=np.where((np.arange(n_sweeps) % 2 == 1) & (sh.type[a_rows] != treg.CONVEX_HULL), -1,
                     a_rows))
    t = lambda a, dtype=f32: torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    v = lambda c: Vec3(*(t(c[:, i]) for i in range(3)))
    q = lambda c: Quat(*(t(c[:, i]) for i in range(4)))
    side = lambda c, local: sweeps.table(
        v(c["pos"]), q(c["orn"]), v(c["vel"]), v(c["omega"]), t(c["radius"]),
        t(c["type"], np.int32), t(c["params"]), t(c["row"], np.int32),
        t(c["exists"], bool) if local else None, v(c["lpos"]) if local else None,
        q(c["lorn"]) if local else None)
    pairs = exists = None
    if form == "explicit":
        pairs = t(np.stack([rng.integers(0, n_sweeps, 256), rng.integers(0, t_n, 256)], 1),
                  np.int32)
        exists = t(rng.uniform(size=256) > 0.125, bool)
    return sweeps.Records(side(a_cols, False), side(b_cols, True), pairs, exists, MAX_T,
                          shapes.hull_rows, Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z))


def draw_spinning(shapes, rows, m=4096, seed=5):
    """``m`` records of cylinders, hulls, boxes and capsules 1-2 m apart at nearly equal
    velocities, both spinning at 5-80 rad/s (explicit form, record k = A row k against B
    row k, ``max_t`` ``MAX_T``): the speed bound is large, each advancement step small, so
    most records run all 32 advancement iterations without an impact, and some run 24 GJK
    iterations in every one of them (17 of 4,096 in a host build of K8)."""
    rng = np.random.default_rng(seed)
    dev = shapes.params.device
    sh = type(shapes)(*(x.cpu().numpy() for x in shapes))
    names = ("cylinder", "hull", "box", "capsule")
    ra = np.asarray([rows[names[k]] for k in rng.integers(0, len(names), m)])
    rb = np.asarray([rows[names[k]] for k in rng.integers(0, len(names), m)])
    apos = _unit(rng, m) * rng.uniform(1.0, 2.0, (m, 1))
    w_a = rng.normal(size=(m, 3)) * rng.uniform(5, 80, (m, 1))
    w_b = rng.normal(size=(m, 3)) * rng.uniform(5, 80, (m, 1))
    vel = rng.normal(scale=0.1, size=(m, 3))
    t = lambda a, dtype=np.float32: torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    v = lambda a: Vec3(*(t(a[:, i]) for i in range(3)))
    q = lambda a: Quat(*(t(a[:, i]) for i in range(4)))
    zero = np.zeros((m, 3))
    a = sweeps.table(v(apos), q(_quats(rng, m)), v(vel), v(w_a), t(sh.max_radius[ra]),
                     t(sh.type[ra], np.int32), t(sh.params[ra]), t(ra, np.int32))
    b = sweeps.table(v(zero), q(_quats(rng, m)), v(vel), v(w_b), t(sh.max_radius[rb]),
                     t(sh.type[rb], np.int32), t(sh.params[rb]), t(rb, np.int32), None,
                     v(zero), q(np.tile([0.0, 0.0, 0.0, 1.0], (m, 1))))
    pairs = t(np.repeat(np.arange(m, dtype=np.int32)[:, None], 2, 1), np.int32)
    return sweeps.Records(a, b, pairs, torch.ones(m, dtype=torch.bool, device=dev), MAX_T,
                          shapes.hull_rows, Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z))


def parent_flat(rec):
    """The flat records the wrapper before the tables built from the same rows: in the
    product form the sweep rows as (R, 1) against the target rows as (1, T), the speed
    bound computed on (R, T) and every tensor expanded and flattened (``sweep_shape_all``);
    in the explicit form each record's rows picked first (``pair_toi``)."""
    fa, fb = rec.a.f, rec.b.f
    ia_, ib_ = rec.a.i, rec.b.i
    if rec.pairs is None:
        n_a, n_b = rec.a.rows, rec.b.rows
        fa, ia_ = fa[:, :, None], ia_[:, :, None]
        fb, ib_ = fb[:, None, :], ib_[:, None, :]
        exists = (ib_[2] != 0).expand(n_a, n_b)
    else:
        ka, kb = rec.pairs[:, 0].long(), rec.pairs[:, 1].long()
        fa, ia_, fb, ib_ = fa[:, ka], ia_[:, ka], fb[:, kb], ib_[:, kb]
        exists = rec.exists
    v = lambda f, c: Vec3(f[c], f[c + 1], f[c + 2])
    q = lambda f, c: Quat(f[c], f[c + 1], f[c + 2], f[c + 3])
    speed_bound = ((v(fa, 7) - v(fb, 7)).length() + v(fa, 10).length() * fa[13]
                   + v(fb, 10).length() * fb[13] + 1e-6)
    shape = speed_bound.shape
    flat = lambda x: (x.expand(shape).reshape(-1) if torch.is_tensor(x)
                      else type(x)(*(flat(c) for c in x)))
    rows = lambda x: x.expand(*shape, x.shape[-1]).reshape(-1, x.shape[-1])
    hull = lambda row: torch.where((row >= 0)[..., None],
                                   rec.hull_rows[row.clamp_min(0).long()], -1)
    return dict(
        sweep=dict(pos=flat(v(fa, 0)), orn=flat(q(fa, 3)), vel=flat(v(fa, 7)),
                   omega=flat(v(fa, 10))),
        type_a=flat(ia_[0]), params_a=rows(torch.movedim(fa[14:26], 0, -1)),
        type_b=flat(ib_[0]), params_b=rows(torch.movedim(fb[14:26], 0, -1)),
        hull_points=rec.hull_points, hull_a=rows(hull(ia_[1])), hull_b=rows(hull(ib_[1])),
        o_pos=flat(v(fb, 0)), o_orn=flat(q(fb, 3)), o_vel=flat(v(fb, 7)),
        o_omega=flat(v(fb, 10)), lpos=flat(v(fb, 26)), lorn=flat(q(fb, 29)),
        speed_bound=flat(speed_bound), exists=flat(exists),
        max_t=torch.full((speed_bound.numel(),), rec.max_t))


def _jax_advance(jshapes, iters):
    """The JAX package's advancement loop over the records, compiled once."""
    import jax
    import jax.numpy as jnp

    from bepuphysics2_tpu.collision import convex as jconvex
    from bepuphysics2_tpu.utils.vec import Quat as JQuat, Vec3 as JVec3, integrate_orientation

    pool = JVec3(jshapes.hull_x, jshapes.hull_y, jshapes.hull_z)
    n_win = jshapes.hull_win.shape[0]

    @jax.jit
    def run(r):
        v = lambda k: JVec3(*(r[k][:, i] for i in range(3)))
        q = lambda k: JQuat(*(r[k][:, i] for i in range(4)))

        def ctx_at(t):
            a_pos = v("a_pos") + v("a_vel") * t
            a_orn = integrate_orientation(q("a_orn"), v("a_omega"), t)
            ow_pos = v("o_pos") + v("o_vel") * t
            ow_orn = integrate_orientation(q("o_orn"), v("o_omega"), t)
            b_pos = ow_pos + ow_orn.rotate(v("lpos"))
            b_orn = ow_orn.mul(q("lorn"))
            return jconvex.SupportCtx(
                r["type_a"], r["params_a"], r["type_b"], r["params_b"],
                a_orn.conjugate().mul(b_orn), a_orn.rotate_inverse(b_pos - a_pos), pool,
                r["hs_a"], r["hc_a"], r["hs_b"], r["hc_b"], hull_windows=n_win)

        def body(_, carry):
            t, done, hit_t = carry
            dist, _, _, margin = jconvex.gjk_closest(ctx_at(t))
            dist = dist - margin
            impact = dist < 1e-4
            hit_t = jnp.where(impact & ~done, t, hit_t)
            new_t = t + jnp.maximum(jnp.maximum(dist, 0.0) / r["speed_bound"], 1e-5)
            new_done = done | impact | (new_t > r["max_t"])
            return jnp.where(new_done, t, new_t), new_done, hit_t

        t0 = jnp.zeros_like(r["speed_bound"])
        hit0 = jnp.full_like(t0, sweeps._INF)
        return jax.lax.fori_loop(0, iters, body, (t0, ~r["exists"], hit0))[2]

    keys = ("a_pos", "a_orn", "a_vel", "a_omega", "o_pos", "o_orn", "o_vel", "o_omega", "lpos",
            "lorn", "type_a", "params_a", "hs_a", "hc_a", "type_b", "params_b", "hs_b", "hc_b",
            "speed_bound", "exists", "max_t")
    return lambda r: np.asarray(run({k: r[k] for k in keys}))


def _gap(got, want):
    both_miss = (got >= 1e30) & (want >= 1e30)
    return np.where(both_miss, 0.0, np.abs(got.astype(np.float64) - want))


def test_advance_matches_the_jax_loop():
    """Held: the records whose JAX result moves by at most 1e-5 under the nudge; each within
    1e-4 of the JAX package's, but for at most one in 256; at least 4 in 5 records held,
    and half of each family; the held records hit and miss as the JAX package's do."""
    import jax

    from bepuphysics2_tpu.shapes import registry as jreg
    from bepuphysics2_tpu_torch.interop import shapes_from_numpy

    jr, jrows = build_registry(jreg)
    _, trows = build_registry(treg)
    assert jrows == trows
    jshapes = jr.device()
    shapes_np = jax.tree_util.tree_map(np.asarray, jshapes)
    tshapes = shapes_from_numpy(shapes_np, "cpu")
    r = draw_records(shapes_np, jrows)
    run = _jax_advance(jshapes, sweeps.SWEEP_ITERS)
    want = run(r)
    held = _gap(run(nudged(r, NUDGE)), want) <= STABLE
    got = sweeps._advance(port_records(r, tshapes, "cpu")).numpy()
    gap = _gap(got, want)
    apart = np.nonzero(held & (gap > TOL))[0]
    print(f"{held.sum()} of {held.size} records held; parted: {apart.tolist()} by "
          f"{gap[apart].tolist()}")
    assert apart.size <= want.size // 256, f"{apart.size} held records parted"
    assert held.mean() >= 0.8, f"only {held.sum()} of {held.size} records held"
    for k in np.unique(r["family"]):
        assert held[r["family"] == k].mean() >= 0.5, f"family {k}: too few records held"
    hits = want < 1e30
    assert 0.2 < hits.mean() < 0.9  # the draw hits and misses
    same = held & (gap <= TOL)
    np.testing.assert_array_equal((got < 1e30)[same], hits[same])


FORMS = ("product", "explicit")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("miss_max_t", [False, True])
def test_factored_plain_matches_flat_records(form, miss_max_t):
    """K8's plain version over the tables (``conservative_advance`` on CPU tensors: the
    records gathered, then ``_advance``) bit for bit against ``_advance`` on the flat
    records that the wrapper before the tables built from the same rows, at the sweep's
    32 iterations (a miss gives 3e38) and at CCD's 12 (a miss gives max_t); the draw
    holds hits and misses, records without a target, and a hull target and mesh
    triangles among the live records."""
    reg, rows = build_registry(treg)
    rec = draw_tables(reg.device("cpu"), rows, form)
    iters = 12 if miss_max_t else sweeps.SWEEP_ITERS
    got = sweeps.conservative_advance(rec, iters, miss_max_t)
    flat = parent_flat(rec)
    want = sweeps._advance(flat, (), iters, miss_max_t)
    assert torch.equal(got, want)
    miss = np.float32(MAX_T) if miss_max_t else np.float32(sweeps._INF)
    live = flat["exists"]
    hits = int((live & (want < float(miss))).sum())
    assert 0 < hits < int(live.sum()), f"{hits} hits of {int(live.sum())} live records"
    assert (~live).any() and bool((want[~live] == float(miss)).all())
    for kind in (treg.CONVEX_HULL, treg.TRIANGLE):
        assert bool((live & (flat["type_b"] == kind)).any())


def _host_build():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools"))
    import k8_host_check

    try:
        return k8_host_check, k8_host_check.build_host()
    except RuntimeError as e:
        pytest.skip(f"K8's host build needs g++: {e}")


@pytest.mark.parametrize("form", FORMS + ("spinning",))
def test_k8_source_on_host(form):
    """K8's CUDA source built for the host with g++ (``tools/k8_host_check.py``: pass 1
    over every record, then pass 2 walking the queue, one lane at a time) bit for bit
    against its plain version, ``sin``, ``cos`` and ``sqrt`` taken in float64 and rounded
    on both sides; the iteration counts K8 reports are those of ``work``'s contract."""
    host, fn = _host_build()
    reg, rows = build_registry(treg)
    shapes = reg.device("cpu")
    rec = (draw_spinning(shapes, rows, 512) if form == "spinning"
           else draw_tables(shapes, rows, form))
    work = torch.zeros(rec.n, 2, dtype=torch.int32)
    got, queued = host.run_host(fn, rec, sweeps.SWEEP_ITERS, False, work)
    with host.float64_rounded():
        want = sweeps.conservative_advance_plain(rec, sweeps.SWEEP_ITERS, False)
    assert torch.equal(got, want)
    assert 0 < queued < rec.n  # pass 2 had records, pass 1 finished some
    adv, gjk = work[:, 0], work[:, 1]
    assert bool((adv <= sweeps.SWEEP_ITERS).all() and (gjk <= 24 * adv).all()
                and (gjk >= adv).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [sweeps.SWEEP_ITERS, 12])
def test_k8_matches_plain_on_card(cuda_device, iters):
    """K8 against its plain version on the card, on the records of the CPU test (drawn
    from the port's own registry, record k as A row k against B row k), at 32 iterations
    (a miss gives 3e38) and at 12 (a miss gives the record's ``max_t``, as ``pair_toi``
    takes it): K8 is built with ``-fmad=false`` and rounds each operation as the plain
    version's PyTorch op does, so every record is bit for bit equal; deterministic run to
    run though the queue's order is not."""
    reg, rows = build_registry(treg)
    shapes = reg.device(cuda_device)
    shapes_np = type(shapes)(*(t.cpu().numpy() for t in shapes))
    rec = records_as_tables(draw_records(shapes_np, rows), shapes, cuda_device)
    miss = iters != sweeps.SWEEP_ITERS
    before = sweeps.conservative_advance.launches
    got = sweeps.conservative_advance(rec, iters, miss)
    assert sweeps.conservative_advance.launches == before + 1
    want = sweeps.conservative_advance_plain(rec, iters, miss)
    equal = got == want
    print(f"K8 at {iters} iterations: {int(equal.sum())} of {equal.numel()} records bit for "
          f"bit equal to the plain version")
    assert bool(equal.all())
    assert torch.equal(got, sweeps.conservative_advance(rec, iters, miss))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("miss_max_t", [False, True])
def test_k8_tables_match_plain_on_card(cuda_device, form, miss_max_t):
    """K8 on the tables of the CPU test, both forms, bit for bit against its plain version
    and against itself on a repeat; one call is one launch; pass 1 leaves some records to
    pass 2 (``counters``) and ``work`` holds each record's iterations."""
    reg, rows = build_registry(treg)
    rec = draw_tables(reg.device(cuda_device), rows, form)
    iters = 12 if miss_max_t else sweeps.SWEEP_ITERS
    work = torch.zeros(rec.n, 2, dtype=torch.int32, device=cuda_device)
    counters = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = sweeps.conservative_advance.launches
    got = sweeps.conservative_advance(rec, iters, miss_max_t, work=work, counters=counters)
    assert sweeps.conservative_advance.launches == before + 1
    assert torch.equal(got, sweeps.conservative_advance_plain(rec, iters, miss_max_t))
    assert torch.equal(got, sweeps.conservative_advance(rec, iters, miss_max_t))
    queued = int(counters[0])
    assert 0 < queued < rec.n
    adv, gjk = work[:, 0], work[:, 1]
    assert bool((adv <= iters).all() and (gjk <= 24 * adv).all() and (gjk >= adv).all())


@pytest.mark.cuda
def test_k8_longest_records_on_card(cuda_device):
    """K8 on ``draw_spinning``'s 4,096 records, among them records whose loop runs all 32
    advancement iterations of 24 GJK iterations each (``work``), bit for bit against its
    plain version and against itself on a repeat."""
    reg, rows = build_registry(treg)
    rec = draw_spinning(reg.device(cuda_device), rows)
    work = torch.zeros(rec.n, 2, dtype=torch.int32, device=cuda_device)
    got = sweeps.conservative_advance(rec, sweeps.SWEEP_ITERS, work=work)
    longest = int(((work[:, 0] == 32) & (work[:, 1] == 32 * 24)).sum())
    print(f"{longest} of {rec.n} records ran 32 x 24 iterations")
    assert longest > 0
    assert torch.equal(got, sweeps.conservative_advance_plain(rec, sweeps.SWEEP_ITERS))
    assert torch.equal(got, sweeps.conservative_advance(rec, sweeps.SWEEP_ITERS))
