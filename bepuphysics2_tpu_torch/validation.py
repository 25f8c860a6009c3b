"""Debug validation: the reference's assert-everywhere strategy as a host-side checker.

Counterpart of ``bepuphysics2_tpu/validation.py``. The reference compiles dense validation
into its Debug builds: NaN/Inf guards under CHECKMATH (BepuUtilities/MathChecker.cs:12),
the solver's structural validators (Solver.cs:348-962) and Simulation.ValidateCollidables
(Simulation.cs:188). ``validate(sim)`` pulls the device state and asserts the same classes
of invariants, with the JAX package's messages; call it between steps in tests and debug
sessions (it syncs with the device). ``torch.autograd.set_detect_anomaly`` has no
counterpart for forward NaNs: the first check below is the CHECKMATH analogue.
"""
from __future__ import annotations

import numpy as np
import torch


class ValidationError(AssertionError):
    pass


def _check(cond: bool, msg: str):
    if not cond:
        raise ValidationError(msg)


def _leaves_with_path(tree, path=""):
    """(path, tensor) of every leaf, the path as ``jax.tree_util.keystr`` writes it:
    ``.field`` for a named tuple's field, ``['key']`` for a dict's key."""
    if torch.is_tensor(tree):
        yield path, tree
    elif tree is None:  # the convex banks of the path a configuration does not run
        return
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, f"{path}.{f}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")


def validate(sim) -> None:
    """Validate the full simulation state. Raises ValidationError with a specific message
    on the first violated invariant."""
    if sim._dirty:
        sim._push()
    state = sim._state

    # 1. Finiteness of every leaf (MathChecker.Validate).
    for name, leaf in _leaves_with_path(state):
        if leaf.is_floating_point():
            arr = leaf.detach().cpu().numpy()
            bad = ~np.isfinite(arr)
            if bad.any():
                idx = np.argwhere(bad)[0]
                raise ValidationError(f"non-finite value in {name} at {idx.tolist()}")

    b = state.bodies
    kind = b.kind.cpu().numpy()
    exists = kind != 0
    awake = b.awake.cpu().numpy()

    # 2. Orientation quaternions normalized for existing bodies.
    qn = np.stack([c.cpu().numpy() for c in b.orn], -1)
    norms = np.linalg.norm(qn, axis=-1)
    off = exists & (np.abs(norms - 1.0) > 1e-3)
    _check(not off.any(), f"unnormalized quaternion at bodies {np.nonzero(off)[0][:5]}")

    # 3. Sleeping dynamics have zero velocity (the IslandSleeper invariant).
    vel = np.stack([c.cpu().numpy() for c in b.vel] + [c.cpu().numpy() for c in b.omega], -1)
    sleeping = (kind == 1) & ~awake & exists
    moving = sleeping & (np.abs(vel).max(-1) > 0.0)
    _check(not moving.any(), f"sleeping body with velocity: {np.nonzero(moving)[0][:5]}")

    # 4. Statics and kinematics have zero inverse mass.
    inv_mass = b.inv_mass.cpu().numpy()
    nd = exists & (kind != 1)
    _check(
        not (nd & (inv_mass != 0.0)).any(),
        f"non-dynamic body with inverse mass: {np.nonzero(nd & (inv_mass != 0))[0][:5]}",
    )

    # 5. Contact records reference existing bodies (ValidateConstraintMaps): the legacy
    # per-frame cache's, as the JAX package checks them, or on the store path (where that
    # cache is left empty) the pair store's live rows, where the records are kept.
    nb = sim.config.body_capacity
    if state.store is None:
        keys = state.cache.key.cpu().numpy().astype(np.int64)
        live = state.cache.valid.cpu().numpy()
        cb, ca = keys[live] // nb, keys[live] % nb  # b-major keys: b x NB + a
    else:
        live = state.store.live.cpu().numpy()
        ca, cb = state.store.body_a.cpu().numpy()[live], state.store.body_b.cpu().numpy()[live]
    _check(
        bool(((ca >= 0) & (ca < nb) & (cb >= 0) & (cb < nb)).all()),
        "contact cache key out of range",
    )
    if live.any():
        _check(bool(exists[ca].all() and exists[cb].all()),
               "contact cache references removed body")

    # 6. Joint stores reference existing bodies.
    for name, store in sim.joints.items():
        used = np.nonzero(store.valid)[0] if hasattr(store, "valid") else []
        for slot in used:
            for h in np.atleast_1d(store.bodies[slot]):
                _check(exists[int(h)], f"joint '{name}' slot {slot} references empty body {h}")
