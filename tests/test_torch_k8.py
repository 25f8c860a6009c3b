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
- On the card (``cuda``), K8 against ``_advance`` on the same records, at 32 iterations
  (a miss gives 3e38) and at 12 (a miss gives the record's ``max_t``, as ``pair_toi``
  takes it): K8 is built with ``-fmad=false`` and rounds each operation as the plain
  version's PyTorch op does, so the two are bit for bit equal where the plain result is
  stable; every record within 1e-4 whose plain result does not move under the nudge.

JAX is imported inside the CPU test, so the file runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_k8.py -q
"""
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
        row_b=np.where(tri, -1, b_shape), speed_bound=sb.astype(f32),
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [sweeps.SWEEP_ITERS, 12])
def test_k8_matches_plain_on_card(cuda_device, iters):
    """K8 against ``_advance`` on the card, the records of the CPU test drawn from the port's
    own registry: the counts of equal and held records are printed."""
    reg, rows = build_registry(treg)
    shapes = reg.device(cuda_device)
    shapes_np = type(shapes)(*(t.cpu().numpy() for t in shapes))
    r = draw_records(shapes_np, rows)
    miss = iters != sweeps.SWEEP_ITERS
    x = port_records(r, shapes, cuda_device)
    before = sweeps.conservative_advance.launches
    got = sweeps.conservative_advance(x, iters, miss).cpu().numpy()
    assert sweeps.conservative_advance.launches == before + 1
    want = sweeps._advance(x, (), iters, miss).cpu().numpy()
    moves = np.max([_gap(sweeps._advance(port_records(nudged(r, e), shapes, cuda_device), (),
                                         iters, miss).cpu().numpy(), want)
                    for e in (NUDGE, -NUDGE)], 0)
    held = moves <= STABLE
    worst = float(_gap(got, want)[held].max(initial=0.0))
    equal = got == want
    print(f"K8 at {iters} iterations: {equal.sum()} of {equal.size} records bit for bit equal "
          f"to the plain version, {held.sum()} stable, largest gap on those {worst:.3e}")
    assert worst <= TOL and held.mean() >= 0.9
    again = sweeps.conservative_advance(x, iters, miss).cpu().numpy()
    np.testing.assert_array_equal(got, again)  # deterministic run to run
