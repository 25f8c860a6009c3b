"""Kernel K1 (the whole substepped contact solve) in the PyTorch port against the JAX
package's ``ops/sweep.py::solve_substeps_contacts``, run in interpret mode on the CPU.

The inputs are one seeded ``synthetic_bank``: two colored slices and one Jacobi slice
whose sides carry mass-split scales of 2 or more, with padding rows in every slice."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.ops import sweep as jsweep
from bepuphysics2_tpu.utils.spring import SpringSettings as JSpring
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Sym3 as JSym3, Vec2 as JVec2, Vec3 as JVec3
from bepuphysics2_tpu.constraints.contact import (
    ContactImpulses as JImpulses, ContactPrestep as JPrestep,
)

from bepuphysics2_tpu_torch.constraints.contact import ContactImpulses, ContactPrestep
from bepuphysics2_tpu_torch.ops import sweep
from bepuphysics2_tpu_torch.utils.spring import SpringSettings
from bepuphysics2_tpu_torch.utils.vec import Vec2, Vec3

NB, SB, N_COLORED, N_JACOBI = 64, 128, 2, 1
SUBSTEPS, ITERS = 2, 2
GRAVITY = (0.0, -10.0, 0.0)


def _bank():
    return sweep.synthetic_bank(NB, SB, N_COLORED, N_JACOBI, seed=3, substeps=SUBSTEPS)


def _jax_k1(bank, angular_mode):
    cols = lambda x: [jnp.asarray(x[:, j]) for j in range(x.shape[1])]
    return jsweep.solve_substeps_contacts(
        jnp.asarray(bank["v6"]), JVec3(*cols(bank["pos"])), JQuat(*cols(bank["orn"])),
        jnp.asarray(bank["inv_mass"]), JSym3(*cols(bank["local_inv_inertia"])),
        jnp.asarray(bank["grav_mask"]), jnp.asarray(bank["integ_mask"]),
        jnp.asarray(bank["ps_t"]), jnp.asarray(bank["imp_t"]), jnp.asarray(bank["idx2"]),
        jnp.asarray(bank["scale"]), bank["h"], bank["inv_h"], 1.0, 1.0,
        nch=128, sb=SB, n_substeps=SUBSTEPS, n_iters=ITERS, angular_mode=angular_mode,
        gravity=GRAVITY, interpret=True,
    )


def _port_k1(bank, angular_mode, device="cpu"):
    return sweep.solve_substeps_contacts(
        *sweep.bank_args(bank, device), sb=SB, n_substeps=SUBSTEPS, n_iters=ITERS,
        angular_mode=angular_mode, gravity=GRAVITY,
    )


def _flat(out):
    v6, pos, orn, imp = out
    as_np = lambda t: np.asarray(t.cpu() if torch.is_tensor(t) else t)
    return (as_np(v6), np.stack([as_np(c) for c in pos]), np.stack([as_np(c) for c in orn]),
            as_np(imp))


def test_bank_has_jacobi_scales_and_padding():
    bank = _bank()
    scale = bank["scale"].reshape(N_COLORED + N_JACOBI, 2, SB)
    valid = bank["ps_t"][sweep.PS_VALID].reshape(-1, SB) > 0.5
    assert (scale[N_COLORED:, :, valid[N_COLORED]] >= 2).mean() > 0.5
    padding = ~np.broadcast_to(valid[:, None, :], scale.shape)
    assert (scale[:N_COLORED] == 1).all() and (scale[padding] == 1).all()
    assert valid.any(axis=1).all() and not valid.all(axis=1).any()


# f32 reordering only: the JAX kernel's bf16x3 one-hot routing is exact, so the two
# differ in the order of the Jacobi sums and in XLA's fusion of the row math.
@pytest.mark.parametrize("angular_mode", [0, 1, 2])
def test_plain_k1_matches_jax_kernel(angular_mode):
    bank = _bank()
    jv6, jpos, jorn, jimp = _flat(_jax_k1(bank, angular_mode))
    pv6, ppos, porn, pimp = _flat(_port_k1(bank, angular_mode))
    np.testing.assert_allclose(pv6, jv6, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ppos, jpos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(porn, jorn, rtol=0, atol=1e-5)
    # Impulses clamp at zero, so an element-wise relative bound is meaningless near it:
    # 1e-5 relative to the bank's largest impulse.
    np.testing.assert_allclose(pimp, jimp, rtol=1e-5, atol=1e-5 * np.abs(jimp).max())
    # The solve moved the bodies and the impulses: the comparison is not of inputs.
    assert np.abs(pv6 - bank["v6"]).max() > 1e-3
    assert np.abs(pimp - bank["imp_t"]).max() > 1e-4


def _random_prestep(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    fields = dict(
        body_a=rng.integers(0, 50, n).astype(np.int32),
        body_b=rng.integers(0, 50, n).astype(np.int32),
        normal=(f(n), f(n), f(n)), offset_a=(f(n, 4), f(n, 4), f(n, 4)),
        offset_b=(f(n), f(n), f(n)), depth=f(n, 4),
        contact_mask=rng.uniform(size=(n, 4)) < 0.6, valid=rng.uniform(size=n) < 0.8,
        friction=f(n) + 1.0, spring=(f(n) * 10 + 30, f(n) + 1.5),
        max_recovery_velocity=f(n) + 2.0, feature=rng.integers(0, 90, (n, 4)).astype(np.int32),
    )
    imp = dict(penetration=f(n, 4), tangent=(f(n), f(n)), twist=f(n))
    return fields, imp


def _build(fields, imp, mod_vec3, mod_vec2, mod_spring, prestep_cls, imp_cls, conv):
    kw = {}
    for k, v in fields.items():
        if k in ("normal", "offset_a", "offset_b"):
            kw[k] = mod_vec3(*(conv(c) for c in v))
        elif k == "spring":
            kw[k] = mod_spring(*(conv(c) for c in v))
        else:
            kw[k] = conv(v)
    im = imp_cls(conv(imp["penetration"]), mod_vec2(*(conv(c) for c in imp["tangent"])),
                 conv(imp["twist"]))
    return prestep_cls(**kw), im


@pytest.mark.parametrize("packer", ["prestep", "impulses"])
def test_packers_match_jax(packer):
    fields, imp = _random_prestep(40, seed=5)
    jps, jim = _build(fields, imp, JVec3, JVec2, JSpring, JPrestep, JImpulses, jnp.asarray)
    pps, pim = _build(fields, imp, Vec3, Vec2, SpringSettings, ContactPrestep, ContactImpulses,
                      torch.from_numpy)
    if packer == "prestep":
        rng = np.random.default_rng(6)
        spring = [rng.uniform(0, 1, 40).astype(np.float32) for _ in range(3)]
        want = np.asarray(jsweep.pack_contact_prestep_cols(jps, [jnp.asarray(s) for s in spring]))
        got = sweep.pack_contact_prestep_cols(pps, [torch.from_numpy(s) for s in spring])
    else:
        want = np.asarray(jsweep.pack_contact_impulses_cols(jim))
        got = sweep.pack_contact_impulses_cols(pim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_bad_inputs():
    args = list(sweep.bank_args(_bank(), "cpu"))
    kw = dict(sb=SB, n_substeps=SUBSTEPS, n_iters=ITERS, angular_mode=0, gravity=GRAVITY)
    bad_dtype = list(args)
    bad_dtype[9] = args[9].long()  # idx2 must be int32
    with pytest.raises(TypeError):
        sweep.solve_substeps_contacts(*bad_dtype, **kw)
    with pytest.raises(ValueError):
        sweep.solve_substeps_contacts(*args, **dict(kw, sb=100))  # B % sb != 0
    bad_layout = list(args)
    bad_layout[7] = args[7].T.contiguous().T  # ps_t not contiguous
    with pytest.raises(ValueError):
        sweep.solve_substeps_contacts(*bad_layout, **kw)


@pytest.mark.parametrize("fn", ["warm_start", "solve", "incremental_depth_update"])
def test_contact_functions_match_jax(fn):
    """``constraints/contact.py``: the per-record contact math that K1's row functions
    restate, on the same random records (1e-5: the same f32 formulas)."""
    from bepuphysics2_tpu.constraints import contact as jcontact
    from bepuphysics2_tpu.utils.vec import Sym3 as JSym3_
    from bepuphysics2_tpu_torch.constraints import contact as tcontact
    from bepuphysics2_tpu_torch.utils.vec import Sym3

    n = 40
    fields, imp = _random_prestep(n, seed=8)
    rng = np.random.default_rng(9)
    vel = rng.uniform(-1, 1, (4, 3, n)).astype(np.float32)
    im = rng.uniform(0.5, 2, (2, n)).astype(np.float32)
    ii = rng.uniform(-0.2, 0.2, (2, 6, n)).astype(np.float32)
    ii[:, [0, 2, 5]] += 2.0

    def run(mod, V3, V2, Spring, Prestep, Imp, S3, conv):
        ps, im_ = _build(fields, imp, V3, V2, Spring, Prestep, Imp, conv)
        v = [V3(*(conv(c) for c in vel[k])) for k in range(4)]
        va, vb = mod.BodyVel(v[0], v[1]), mod.BodyVel(v[2], v[3])
        ia = mod.GatheredInertia(conv(im[0]), S3(*(conv(c) for c in ii[0])))
        ib = mod.GatheredInertia(conv(im[1]), S3(*(conv(c) for c in ii[1])))
        if fn == "warm_start":
            return mod.warm_start(ps, im_, ia, ib, va, vb)
        if fn == "solve":
            return mod.solve(ps, im_, ia, ib, va, vb, np.float32(1 / 240), np.float32(240))
        return mod.incremental_depth_update(ps, va, vb, np.float32(1 / 240)).depth

    want = run(jcontact, JVec3, JVec2, JSpring, JPrestep, JImpulses, JSym3_, jnp.asarray)
    got = run(tcontact, Vec3, Vec2, SpringSettings, ContactPrestep, ContactImpulses, Sym3,
              torch.from_numpy)
    flat = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    got_l = [x.numpy() for x in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    want_l = flat(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
