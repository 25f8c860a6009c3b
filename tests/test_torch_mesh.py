"""The port's meshes, compound-vs-compound pairs and ``CompoundBuilder`` against the JAX
package's.

- ``mesh_closed_second_moment``, ``mesh_open_inertia`` and ``Mesh.compute_inertia``
  within 1e-6; every ``ShapeData`` field of a registry holding a mesh and compounds
  (child rows, triangles, per-child AABBs, ``cl_*``) equal to the JAX registry's;
  ``CompoundBuilder.build`` equal.
- ``expand_compound_compound`` on a state carried from the JAX package (dumbbells and
  a two-child compound on a height-field mesh and on each other, every pair of bodies):
  slots, rows, types and overflow exact, poses within 1e-6; then
  ``narrow_phase_compound`` with ``max_cc_pairs > 0`` on the JAX broad phase's pairs
  (compound-vs-convex, compound-vs-compound and compound-vs-mesh records in one bank)
  within 1e-5. Both hold the port's one repair of the JAX package (ROADMAP queue 3): a
  compound child whose type id is below the triangle's (a sphere, capsule or box) gets
  contacts from a mesh in the port, where the JAX package culls them all; the records
  so kept are held within 1e-5 to the JAX package's own testers and one-sided mesh test
  fed the same child pairs with the convex side set as the port sets it.

``tests/test_torch_compound_behaviour.py`` holds the behaviour of the JAX package's
``tests/test_compound.py`` on the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu import bodies as jbodies
from bepuphysics2_tpu.collision import compound as jcompound
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.shapes import registry as jreg
from bepuphysics2_tpu.shapes.builder import CompoundBuilder as JCompoundBuilder

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch.collision import broadphase, compound, narrowphase
from bepuphysics2_tpu_torch.interop import _to_torch, shapes_from_numpy
from bepuphysics2_tpu_torch.shapes import registry as treg

from test_torch_collision import _close, _jax_pairs, _np

DT = np.float32(1 / 60)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _height_field(n, cell=1.0, amp=0.4, lo=0.0):
    """Upward-wound triangles of an n x n height field y = amp sin(x/2) cos(z/2)."""
    y = lambda x, z: amp * np.sin(x / 2) * np.cos(z / 2)
    tris = []
    for i in range(n):
        for j in range(n):
            x0, z0, x1, z1 = lo + i * cell, lo + j * cell, lo + (i + 1) * cell, lo + (j + 1) * cell
            a, b, c, d = ((x0, y(x0, z0), z0), (x0, y(x0, z1), z1), (x1, y(x1, z0), z0),
                          (x1, y(x1, z1), z1))
            tris += [(a, b, c), (c, b, d)]
    return tris


def _closed_mesh():
    """A box of half extents (0.6, 0.4, 0.9) centred at (0.3, -0.2, 0.1), outward-wound."""
    c, h = np.array([0.3, -0.2, 0.1]), np.array([0.6, 0.4, 0.9])
    v = [c + h * np.array([sx, sy, sz]) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    return [tuple(tuple(v[i]) for i in t) for q in quads for t in ((q[0], q[1], q[2]),
                                                                  (q[0], q[2], q[3]))]


def test_mesh_inertia_matches_jax():
    closed, open_ = _closed_mesh(), _height_field(5)
    for got, want in zip(treg.mesh_closed_second_moment(closed, 2.5),
                         jreg.mesh_closed_second_moment(closed, 2.5)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(treg.mesh_open_inertia(open_, 1.5), jreg.mesh_open_inertia(open_, 1.5)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tm, jm = tbp.Mesh.build(closed, (1.0, 2.0, 0.5)), jbp.Mesh.build(closed, (1.0, 2.0, 0.5))
    assert tm.triangles == jm.triangles and tm.maximum_radius() == jm.maximum_radius()
    for got, want in zip(tm.compute_inertia(3.0), jm.compute_inertia(3.0)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(tm.compute_inertia_with_center(3.0),
                         jm.compute_inertia_with_center(3.0)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


_CORNERS = [(0.3 * sx, 0.25 * sy, 0.3 * sz) for sx in (-1, 1) for sy in (-1, 1)
            for sz in (-1, 1)]


def _registry(mod, registry_cls):
    """A mesh of 800 triangles, a dumbbell of two boxes, the same dumbbell of two convex
    hulls of the box's corners, a sphere-and-capsule compound, and the convex shapes they
    use."""
    reg = registry_cls(16)
    rows = dict(sphere=reg.add(mod.Sphere(0.3)), box=reg.add(mod.Box(0.3, 0.25, 0.3)),
                capsule=reg.add(mod.Capsule(0.2, 0.3)),
                hull=reg.add(mod.ConvexHull.from_points(np.array(_CORNERS))))
    rows["mesh"] = reg.add(mod.Mesh.build(_height_field(20, lo=-10.0)))
    rows["dumbbell"] = reg.add(mod.Compound.build([(rows["box"], (-0.45, 0.0, 0.0)),
                                                   (rows["box"], (0.45, 0.0, 0.0))]))
    rows["hull_dumbbell"] = reg.add(mod.Compound.build([(rows["hull"], (-0.45, 0.0, 0.0)),
                                                        (rows["hull"], (0.45, 0.0, 0.0))]))
    rows["pair"] = reg.add(mod.Compound.build([
        (rows["sphere"], (0.0, 0.0, -0.4)),
        (rows["capsule"], (0.0, 0.0, 0.4), (0.7071068, 0.0, 0.0, 0.7071068))]))
    return reg, rows


def test_mesh_registry_matches_jax():
    (jr, _), (tr, _) = _registry(jbp, jreg.ShapeRegistry), _registry(tbp, treg.ShapeRegistry)
    want, got = _np(jr.device()), tr.device("cpu")
    for f in treg.ShapeData._fields:
        if f == "hull_rows":
            continue
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    assert int(want.child_count.max()) == 800 and want.cl_count.shape[1] == 64


def test_compound_builder_matches_jax():
    out = []
    for mod, builder in ((jbp, JCompoundBuilder), (tbp, tbp.CompoundBuilder)):
        sim = mod.Simulation(mod.SimConfig(body_capacity=8, max_pairs=8), **(
            dict(device="cpu") if mod is tbp else {}))
        b = builder(sim)
        b.add(mod.Sphere(0.1), (-0.5, 0, 0), 1.0)
        b.add(mod.Box(0.2, 0.1, 0.3), (0.5, 0.2, 0), 2.0, (0.0, 0.3826834, 0.0, 0.9238795))
        b.add(mod.Capsule(0.1, 0.4), (0.0, -0.3, 0.6), 0.5)
        out.append((b.build(), b.build_body((1.0, 2.0, 3.0))))
    (jb, jd), (tb, td) = out
    assert tb == jb
    for f in ("position", "shape", "inv_mass", "inv_inertia"):
        assert getattr(td, f) == getattr(jd, f), f


def _cc_state():
    """The JAX registry of ``_registry`` and 24 bodies: the mesh, dumbbells and pair
    compounds resting on it, on each other and beside convex bodies, tilted at random."""
    reg, rows = _registry(jbp, jreg.ShapeRegistry)
    buf = jbodies.BodyBuffer(32)
    rng = np.random.default_rng(5)
    buf.add(jbodies.StaticDescription(position=(0.0, 0.0, 0.0), shape=rows["mesh"]))
    ii = (2.0, 0.0, 2.0, 0.0, 0.0, 2.0)
    for k in range(23):
        name = ("dumbbell", "pair", "hull_dumbbell", "sphere", "box")[k % 5]
        q = rng.normal(size=4) * np.array([0.2, 1.0, 0.2, 1.0])
        p = (rng.uniform(-3, 3), 0.45 + 0.5 * (k // 8) + rng.uniform(-0.1, 0.2),
             rng.uniform(-3, 3))
        buf.add(jbodies.BodyDescription(position=p, shape=rows[name], inv_mass=1.0,
                                        inv_inertia=ii, kind=jbodies.KIND_DYNAMIC,
                                        orientation=tuple(q / np.linalg.norm(q)),
                                        velocity=tuple(rng.uniform(-1, 1, 3))))
    return _np(reg.device()), _np(buf.device())


@pytest.fixture(scope="module")
def cc_inputs():
    sd, st = _cc_state()
    return dict(sd=sd, st=st, pairs=_np(_jax_pairs(jax.tree_util.tree_map(jnp.asarray, st),
                                                   jax.tree_util.tree_map(jnp.asarray, sd))))


def _cc_bank(ci, mod):
    """``narrow_phase_compound`` of the cc scene's broad-phase pairs with an empty cache
    (8 children per compound pair, 32 cc pairs of 4 x 4)."""
    present = (0, 1, 2, 5, 6, 8)
    if mod == "jax":
        jst = jax.tree_util.tree_map(jnp.asarray, ci["st"])
        jsd = jax.tree_util.tree_map(jnp.asarray, ci["sd"])
        jp = jax.tree_util.tree_map(jnp.asarray, ci["pairs"])
        return _np(jnarrow.narrow_phase_compound(
            jst, jsd, jp, jnarrow.PairCache.empty(64 * 8 + 32 * 16), DT, 64, 8, 128,
            present_types=present, max_cc_pairs=32, cc_children_per_side=4))
    p = ci["pairs"]
    t = lambda x: torch.from_numpy(np.array(x))
    return narrowphase.narrow_phase_compound(
        _to_torch(ci["st"], "cpu"), shapes_from_numpy(ci["sd"], "cpu"),
        broadphase.PairList(t(p.a), t(p.b), t(p.valid), t(np.array(p.overflow)), t(p.demand)),
        _to_torch(_np(narrowphase.PairCache.empty(64 * 8 + 32 * 16)), "cpu"), float(DT), 64,
        8, 128, present_types=present, max_cc_pairs=32, cc_children_per_side=4)


@pytest.fixture(scope="module")
def cc_banks(cc_inputs):
    return _cc_bank(cc_inputs, "jax"), _cc_bank(cc_inputs, "port")


@pytest.mark.parametrize("max_cc_pairs,per_side", [(64, 4), (8, 2)])
def test_expand_compound_compound_matches_jax(cc_inputs, max_cc_pairs, per_side):
    """Every pair of the 24 bodies; at (8, 2) the pair count overflows."""
    n = 24
    a, b = np.triu_indices(n, 1)
    a, b = a.astype(np.int32), b.astype(np.int32)
    valid = np.ones(len(a), bool)
    jst = jax.tree_util.tree_map(jnp.asarray, cc_inputs["st"])
    jsd = jax.tree_util.tree_map(jnp.asarray, cc_inputs["sd"])
    want = _np(jcompound.expand_compound_compound(
        jst, jsd, jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid), max_cc_pairs, per_side, 128))
    t = lambda x: torch.from_numpy(np.array(x))
    got = compound.expand_compound_compound(
        _to_torch(cc_inputs["st"], "cpu"), shapes_from_numpy(cc_inputs["sd"], "cpu"), t(a), t(b),
        t(valid), max_cc_pairs, per_side, 128)
    # The port's repair (ROADMAP queue 3): a record whose j side is a mesh triangle takes
    # the owner of its i side for the convex one; the JAX package takes the j side's.
    tri_j = (np.asarray(want.type_j) == jreg.TRIANGLE) & (np.asarray(want.shape_j) == -1)
    repaired = np.where(tri_j, ~np.asarray(want.swapped), np.asarray(want.conv_is_a))
    assert (repaired != np.asarray(want.conv_is_a))[np.asarray(want.valid)].any()
    _close(got, want._replace(conv_is_a=repaired), tol=1e-6)
    types = np.asarray(want.type_j)[np.asarray(want.valid)]  # canonical: the higher type
    assert int(np.asarray(want.valid).sum()) > 20 and (types == jreg.TRIANGLE).any()
    assert bool(want.overflow) or max_cc_pairs > 8


def _dumbbell_rows(ci, ps, kid_row):
    st, sd = ci["st"], ci["sd"]
    shape = np.asarray(st.shape)
    kids = np.asarray(sd.child_shape)[np.asarray(sd.child_start)[shape]]
    dumbbell = (np.asarray(sd.type)[shape] == jreg.COMPOUND) & (kids == kid_row)
    return dumbbell[np.asarray(ps.body_a)] | dumbbell[np.asarray(ps.body_b)]


def _hull_dumbbell_rows(ci, ps):
    """Records of a convex-hull dumbbell: they take the generic GJK/MPR manifold."""
    return _dumbbell_rows(ci, ps, 3)


def _box_dumbbell_mesh_rows(ci, ps):
    """Records on the mesh (body 0) of a compound with sphere, capsule or box children:
    the box dumbbells and the sphere-and-capsule pairs."""
    st, sd = ci["st"], ci["sd"]
    shape = np.asarray(st.shape)
    comp = np.asarray(sd.type)[shape] == jreg.COMPOUND
    return ((np.asarray(ps.body_a) == 0) & comp[np.asarray(ps.body_b)]
            & ~_hull_dumbbell_rows(ci, ps))


def _tree_keep(got, want, rows):
    """``got`` with ``want``'s values on ``rows`` (a named tuple of tensors, or one)."""
    if torch.is_tensor(got):
        w = torch.from_numpy(np.array(want))
        return torch.where(rows.reshape((-1,) + (1,) * (got.dim() - 1)), w, got)
    return type(got)(*(_tree_keep(g, w, rows) for g, w in zip(got, want)))


def test_narrow_phase_compound_cc_matches_jax(cc_inputs, cc_banks):
    """One bank of compound-vs-convex and compound-vs-compound records (mesh triangles
    included), keyed pair x (8 + 16) + slot: every output within 1e-5, integers exact,
    but the box dumbbells' records on the mesh, which the port repairs (the next test),
    and the contact offsets and feature ids of the hull dumbbells' records, which come
    from the generic manifold: there a box-shaped hull's face ties with the triangle's to
    the last bit, and the two packages place the contacts at different tied vertices
    (ROADMAP queue 3); their depths, normals and masks are held."""
    want, got = cc_banks
    generic = _hull_dumbbell_rows(cc_inputs, want[0])
    repaired = torch.from_numpy(_box_dumbbell_mesh_rows(cc_inputs, want[0]))
    moved = ((got[0].offset_a.x.numpy() - np.asarray(want[0].offset_a.x)) != 0).any(-1)
    print(f"{int(generic.sum())} records of hull dumbbells, of which {int(moved[generic].sum())}"
          " place their contacts elsewhere")
    ps = _tree_keep(got[0], want[0], repaired)
    tied = torch.from_numpy(generic)
    ps = ps._replace(offset_a=_tree_keep(ps.offset_a, want[0].offset_a, tied),
                     feature=_tree_keep(ps.feature, want[0].feature, tied))
    rest = tuple(_tree_keep(g, w, repaired) for g, w in zip(got[1:4], want[1:4]))
    _close((ps,) + rest + (got[4],), want, tol=1e-5)
    assert not moved[~(generic | repaired.numpy())].any()
    valid = np.asarray(want[0].valid)
    assert valid[: 64 * 8].sum() > 4 and valid[64 * 8:].sum() > 4  # both kinds live


def test_box_children_get_mesh_contacts_in_the_port(cc_inputs, cc_banks):
    """The port's repair of a fault of the JAX package (ROADMAP queue 3): a
    compound-vs-mesh record orders its two children by type id, and the JAX package
    takes the owner of its j side for the convex one (``compound.py:446``); a box,
    sphere or capsule child has a lower type id than the triangle, so the mesh is taken
    for the convex side and the one-sided test culls every such record. The JAX package
    keeps no record of the box dumbbells or the sphere-and-capsule pairs on the mesh; the
    port keeps them, as both keep the hull dumbbells' records."""
    want, got = cc_banks
    rows = _box_dumbbell_mesh_rows(cc_inputs, want[0])
    hull = _hull_dumbbell_rows(cc_inputs, want[0]) & (np.asarray(want[0].body_a) == 0)
    assert np.asarray(want[0].valid)[rows].sum() == 0
    assert got[0].valid.numpy()[rows].sum() > 0
    assert np.asarray(want[0].valid)[hull].sum() > 0 and got[0].valid.numpy()[hull].sum() > 0


@pytest.fixture(scope="module")
def jax_bank_convex_side_set(cc_inputs):
    """The JAX package's ``narrow_phase_compound`` on the same pairs, its
    ``expand_compound_compound`` records given the convex side that the port takes (the
    owner of the child that is not a mesh triangle): the JAX package's own testers and
    one-sided mesh test then see each repaired record as the port does."""
    real = jnarrow.expand_compound_compound

    def convex_side_set(*args, **kwargs):
        cc = real(*args, **kwargs)
        tri_j = (cc.type_j == jreg.TRIANGLE) & (cc.shape_j == -1)
        return cc._replace(conv_is_a=jnp.where(tri_j, ~cc.swapped, cc.conv_is_a))

    jnarrow.expand_compound_compound = convex_side_set
    try:
        return _cc_bank(cc_inputs, "jax")
    finally:
        jnarrow.expand_compound_compound = real


def test_repaired_mesh_records_match_jax_testers(cc_inputs, cc_banks,
                                                 jax_bank_convex_side_set):
    """The records that the port's repair keeps (box, sphere and capsule children on the
    mesh) against the JAX package's testers and one-sided mesh test fed the same child
    pairs with the convex side set as the port sets it: normals, offsets, depths, masks
    and features within 1e-5, and the same records valid."""
    want, got = jax_bank_convex_side_set, cc_banks[1]
    rows = _box_dumbbell_mesh_rows(cc_inputs, want[0])
    assert np.asarray(want[0].valid)[rows].sum() > 4  # the records are live in both
    want_rows = jax.tree_util.tree_map(lambda x: np.asarray(x)[rows], want[0])
    _close(_tree_rows(got[0], torch.from_numpy(rows)), want_rows, tol=1e-5)


def _tree_rows(tree, rows):
    """The ``rows`` of every per-record tensor of a named tuple of tensors."""
    if torch.is_tensor(tree):
        return tree[rows]
    return type(tree)(*(_tree_rows(x, rows) for x in tree))
