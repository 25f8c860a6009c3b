"""Island sleeping/waking as pure masking (counterpart of ``bepuphysics2_tpu/sleep.py``;
reference IslandSleeper.cs:13, IslandAwakener.cs:17).

Island labels come from label propagation with pointer jumping over the constraint graph;
an island sleeps when every member has stayed below its velocity threshold for
``sleep_time``; a new contact from an awake body wakes its whole stored island.

The JAX package skips the label pass and the wake pass behind ``lax.cond`` when nothing
can change. The port runs both unconditionally: when the JAX condition is false, the
passes return their input unchanged (no candidate → no island sleeps; nothing asleep →
nothing wakes), so the results are identical and the step needs no host sync.

Under the constraint-sharded step (``group``, a ``torch.distributed`` process group, where
the JAX package takes ``axis_name``) the bodies are replicated and the constraint banks
sharded: each label round ends in an ``all_reduce(MIN)`` of the labels, and the woken
labels combine with an ``all_reduce(MAX)``, so islands spanning ranks sleep and wake as
on one device.
"""
from __future__ import annotations

import torch

from .bodies import BodyState, KIND_DYNAMIC
from .parallel import comm
from .utils.vec import Vec3

LABEL_ROUNDS = 4  # scatter-min + pointer-jump rounds


def _collect_edges(presteps, joint_banks: dict):
    """All constraint edges (a, b, live) from contact and joint banks."""
    if not isinstance(presteps, (list, tuple)):
        presteps = [presteps]
    edges = [(p.body_a, p.body_b, p.valid) for p in presteps]
    for name in sorted(joint_banks.keys()):
        bank = joint_banks[name]
        bodies, valid = bank["bodies"], bank["valid"]
        for j in range(1, bodies.shape[1]):
            edges.append((bodies[:, 0], bodies[:, j], valid))
    return (torch.cat([e[0] for e in edges]), torch.cat([e[1] for e in edges]),
            torch.cat([e[2] for e in edges]))


def compute_islands(state: BodyState, presteps, joint_banks: dict,
                    group=None) -> torch.Tensor:
    """Island label per body (min body index in the island) over dynamic bodies joined by
    live constraints; non-dynamic bodies keep their own index. ``group`` (JAX
    ``axis_name``): the banks are this rank's shard, and each round's labels take the
    minimum over the ranks."""
    n = state.pos.x.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=state.kind.device)
    ea, eb, live = _collect_edges(presteps, joint_banks)
    ea, eb = ea.long(), eb.long()
    edge_ok = live & (state.kind[ea] == KIND_DYNAMIC) & (state.kind[eb] == KIND_DYNAMIC)
    for _ in range(LABEL_ROUNDS):
        m = torch.where(edge_ok, torch.minimum(labels[ea], labels[eb]), n)
        labels = labels.scatter_reduce(0, ea, m, "amin", include_self=True)
        labels = labels.scatter_reduce(0, eb, m, "amin", include_self=True)
        if group is not None:
            labels = comm.pmin(labels, group)
        labels = labels[labels.long()]
        labels = labels[labels.long()]
    return labels


def wake_touched(state: BodyState, prestep, group=None) -> BodyState:
    """Wake sleeping bodies contacted by awake dynamics — whole stored island at once.
    ``group`` (JAX ``axis_name``): ``prestep`` is this rank's shard, and a label woken on
    any rank wakes its island on every rank."""
    n = state.pos.x.shape[0]
    sleeping_dyn = (state.kind == KIND_DYNAMIC) & ~state.awake
    a, b = prestep.body_a.long(), prestep.body_b.long()
    awake_dyn = (state.kind == KIND_DYNAMIC) & state.awake
    touch_b = prestep.valid & awake_dyn[a] & sleeping_dyn[b]
    touch_a = prestep.valid & awake_dyn[b] & sleeping_dyn[a]
    lbl = state.sleep_island.long()
    woken_label = torch.zeros(n + 1, dtype=torch.bool, device=a.device)  # n = sink
    woken_label.index_fill_(0, torch.where(touch_b, lbl[b], n), True)
    woken_label.index_fill_(0, torch.where(touch_a, lbl[a], n), True)
    if group is not None:
        woken_label = comm.pmax(woken_label, group)
    wake = sleeping_dyn & woken_label[:n][lbl]
    return state._replace(
        awake=state.awake | wake,
        sleep_timer=torch.where(wake, 0.0, state.sleep_timer),
    )


def update_sleep(state: BodyState, presteps, joint_banks: dict, dt, sleep_time: float,
                 group=None) -> BodyState:
    """Post-solve candidacy update + island sleep decision (``group``: see
    ``compute_islands``)."""
    n = state.pos.x.shape[0]
    dyn_awake = (state.kind == KIND_DYNAMIC) & state.awake
    kinetic = state.vel.length_squared() + state.omega.length_squared()
    below = kinetic < state.sleep_threshold
    can_sleep = state.sleep_threshold >= 0.0
    timer = torch.where(dyn_awake & below, state.sleep_timer + dt, 0.0)
    candidate = dyn_awake & below & can_sleep & (timer > sleep_time)

    labels = compute_islands(state, presteps, joint_banks, group=group).long()
    # Island sleeps iff every dynamic awake member is a candidate.
    island_all = torch.ones(n + 1, dtype=torch.int32, device=labels.device)  # n = sink
    island_all = island_all.scatter_reduce(
        0, torch.where(dyn_awake, labels, n), candidate.to(torch.int32), "amin",
        include_self=True)
    go_sleep = dyn_awake & (island_all[:n][labels] > 0)
    zero = torch.zeros_like(state.vel.x)
    zv = Vec3(zero, zero, zero)
    return state._replace(
        awake=state.awake & ~go_sleep,
        vel=state.vel.where(~go_sleep, zv),
        omega=state.omega.where(~go_sleep, zv),
        sleep_timer=timer,
        sleep_island=torch.where(go_sleep, labels.to(torch.int32), state.sleep_island),
    )
