"""K8 and its callers against an earlier commit's, on one CUDA card, in one process.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k8_vs_parent.py --parent build/parent [--reps 5]

The earlier package is imported from ``<parent>/bepuphysics2_tpu_torch`` under another
name (its modules import each other relatively) and builds its own K8 from its own source
into ``<parent>/build/kernels``. Then:

1. Phase 33's call. The 4,096-body mesh-terrain pile settled as ``chip_smoke.py``'s phase
   32 settles it (33 landing steps, ``autosize``, 48 steps), then phase 33's 256 capsule
   sweeps at ``prune_k`` 0, run by both packages' ``sweep_shape_all`` on the same state:
   the same hits. Their K8 inputs are captured: the current package's tables, the
   earlier one's flat records. Both K8s bit for bit equal, with the same iteration counts
   (``work``); each K8 call through its wrapper and alone (its C entry point on the
   arguments its wrapper makes), the current pass 1 and pass 2 alone, and each whole
   ``sweep_shape_all`` call (synced host clock), in turns (earlier, current, current,
   earlier); the share of records pass 1 finishes; the lane efficiency of the earlier
   one-thread-a-record K8 (``chip_smoke._lane_efficiency`` of its ``work`` in its record
   order); the bound of each.
2. CCD. One ``pair_toi`` call of phase 35's scene (``chip_smoke.ccd_world``: the 4,096-body
   pile and 256 continuous spheres, after 8 steps) and one of phase 31's tank scene
   (``chip_smoke.vehicle_world("tank")``, after 10 steps), run by both packages: the same
   bits; the CUDA events per call (kernels, copies, fills) and their summed device ms
   (``torch.profiler``), of the whole pass and of the K8 wrapper alone; the synced ms per
   call (median of ``--reps``), in turns.
3. Phase 35's steps/s: the scene built anew and stepped 48 timed steps with each
   package's ``pair_toi`` in ``narrowphase`` (everything else the current package's), in
   turns: the same ``state_hash``.

Prints a line per measurement and, last, one JSON object. Imports nothing of JAX.
"""
import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bepuphysics2_tpu_torch.collision import narrowphase  # noqa: E402
from bepuphysics2_tpu_torch.collision import sweeps as tsweeps  # noqa: E402

DT = cs.DT


def load_parent(root):
    """The earlier package at ``<root>/bepuphysics2_tpu_torch``, as ``parent_torch``."""
    pkg = Path(root).resolve() / "bepuphysics2_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_torch.collision.sweeps")


class _spy:
    """Records the calls of ``module.name`` inside a block (the last ``keep`` of them)."""

    def __init__(self, module, name, keep=1):
        self.module, self.name, self.keep = module, name, keep

    def __enter__(self):
        real, calls = getattr(self.module, self.name), []

        def spy(*a, **k):
            calls.append((a, k))
            del calls[:-self.keep]
            return real(*a, **k)

        self.real = real
        setattr(self.module, self.name, spy)
        return calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def _advance_args(call):
    """(records, iterations, miss rule) of a recorded ``advance(x, custom_ids, iters,
    miss_max_t)`` call."""
    a, k = call
    iters = a[2] if len(a) > 2 else k.get("iters", tsweeps.SWEEP_ITERS)
    return a[0], iters, a[3] if len(a) > 3 else k.get("miss_max_t", False)


def _profile(fn):
    """(CUDA events, their summed device ms) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    return len(events), sum(e.duration_ns() for e in events) / 1e6


def _synced_median(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _turns(measure, parent, current):
    """``measure(f)`` of parent, current, current, parent: ({"parent": [..], "current":
    [..]})."""
    out = {"parent": [], "current": []}
    for who in ("parent", "current", "current", "parent"):
        out[who].append(measure(parent if who == "parent" else current))
    return out


def _parent_bare_ms(psweeps, call, reps):
    """The earlier K8's C entry point alone, relaunched on its wrapper's arguments."""
    build = sys.modules["parent_torch.ops.build"]
    key = ("conservative_advance", "conservative_advance_launch")
    real, out = build._bound[key], {}

    def spy(*args):
        err = real(*args)
        out["ms"] = cs._time_ms(lambda: real(*args), reps)
        return err

    build._bound[key] = spy
    try:
        call()
    finally:
        build._bound[key] = real
    return out["ms"]


def phase33_call(dev, psweeps, reps):
    from bepuphysics2_tpu_torch import Capsule
    from bepuphysics2_tpu_torch.models import build_terrain_pile_sim

    sim, _ = build_terrain_pile_sim(cs.TERRAIN_BODIES, cs.TERRAIN_CELLS, device=dev)
    sim.run(33, DT)
    sim.autosize(DT, probe_steps=8)
    sim.run(48, DT)
    # phase_queries' draws, in its order.
    n = sim.body_count - 1
    rng = np.random.default_rng(12)
    pos = np.stack([c.cpu().numpy() for c in sim.state.bodies.pos], -1)[1:n + 1]
    _ = pos + rng.normal(scale=0.4, size=pos.shape)
    d = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (n, 1))
    d[::4] += rng.normal(scale=0.3, size=d[::4].shape).astype(np.float32)
    _ = rng.integers(0, n)
    ps = (pos[rng.integers(0, n, 256)] + np.array([0, 3.0, 0])).astype(np.float32)
    vs = np.tile(np.array([0.0, -2.0, 0.0], np.float32), (256, 1))
    ws = rng.normal(scale=0.5, size=(256, 3)).astype(np.float32)
    with _spy(tsweeps, "sweep_shape_all") as args:
        sim.sweep_shape_batch(Capsule(0.3, 0.4), ps, vs, max_t=3.0, angular_velocities=ws)
    a, k = args[-1]
    with _spy(tsweeps, "advance") as t_adv:
        t_hit = tsweeps.sweep_shape_all(*a, **k)
    with _spy(psweeps, "advance") as p_adv:
        p_hit = psweeps.sweep_shape_all(*a, **k)
    for f in ("hit", "t", "body"):
        cs._require(torch.equal(getattr(t_hit, f), getattr(p_hit, f)),
                    f"sweep_shape_all's {f} differs from the earlier commit's")
    rec, iters, miss = _advance_args(t_adv[-1])
    x, p_iters, p_miss = _advance_args(p_adv[-1])
    n_rec = rec.n
    t_work = torch.zeros(n_rec, 2, dtype=torch.int32, device=dev)
    p_work = torch.zeros(n_rec, 2, dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    got = tsweeps.conservative_advance(rec, iters, miss, work=t_work, counters=counters)
    was = psweeps.conservative_advance(x, p_iters, p_miss, work=p_work)
    cs._require(torch.equal(got, was), "K8 differs from the earlier K8")
    cs._require(torch.equal(t_work, p_work), "K8's iteration counts differ from the earlier's")
    queued = int(counters[0])
    wrapper = _turns(lambda f: cs._time_ms(f, reps),
                     lambda: psweeps.conservative_advance(x, p_iters, p_miss),
                     lambda: tsweeps.conservative_advance(rec, iters, miss))
    alone, parts = {"parent": [], "current": []}, []
    for who in ("parent", "current", "current", "parent"):
        if who == "parent":
            alone[who].append(_parent_bare_ms(
                psweeps, lambda: psweeps.conservative_advance(x, p_iters, p_miss), reps))
        else:
            p = cs._k8_parts_ms(lambda: tsweeps.conservative_advance(rec, iters, miss), reps)
            alone[who].append(p["both"])
            parts.append(p)
    whole = _turns(lambda f: _synced_median(f, 3), lambda: psweeps.sweep_shape_all(*a, **k),
                   lambda: tsweeps.sweep_shape_all(*a, **k))
    adv_ops, gjk_ops = cs._k8_ops(rec)
    w = t_work.sum(0).tolist()
    ops = w[0] * adv_ops + w[1] * gjk_ops
    bound_ms, bound_by = cs._bound(cs._k8_bytes(rec), ops)
    hull_width = rec.hull_rows.shape[1]
    old_bytes = n_rec * (35 + 3 + 12 + hull_width + 1) * 4 + cs._nbytes(*rec.hull_points)
    old_bound_ms, old_by = cs._bound(old_bytes, ops)
    out = dict(
        records=n_rec, iterations=w, bit_equal=True, pass1_finished=1 - queued / n_rec,
        lane_efficiency_parent=dict(advancement=cs._lane_efficiency(p_work[:, 0]),
                                    gjk=cs._lane_efficiency(p_work[:, 1])),
        wrapper_ms=wrapper, alone_ms=alone,
        pass1_ms=[p["pass 1"] for p in parts], pass2_ms=[p["pass 2"] for p in parts],
        sweep_shape_all_ms=whole, bound_ms=bound_ms, bound_by=bound_by,
        per_record_bound_ms=old_bound_ms, per_record_bound_by=old_by,
        k8_events=dict(parent=_profile(lambda: psweeps.conservative_advance(x, p_iters,
                                                                             p_miss)),
                       current=_profile(lambda: tsweeps.conservative_advance(rec, iters,
                                                                            miss))))
    print(f"[k8 phase 33] {n_rec} records, {w[0]} advancement and {w[1]} GJK iterations, "
          f"bit for bit equal to the earlier K8 with the same counts; wrapper ms "
          f"{wrapper}; alone ms {alone}; pass 1 ms {out['pass1_ms']}, pass 2 ms "
          f"{out['pass2_ms']}; pass 1 finished {out['pass1_finished']:.4f}; lane efficiency "
          f"of one thread a record {out['lane_efficiency_parent']}; sweep_shape_all ms "
          f"{whole}; bound {bound_ms:.4f} ms ({bound_by}), per-record layout's "
          f"{old_bound_ms:.4f} ({old_by}); CUDA events and device ms of one K8 wrapper call "
          f"{out['k8_events']}")
    return out


def ccd_call(label, sim, steps, psweeps, reps):
    with _spy(narrowphase, "pair_toi") as calls:
        sim.run(steps, DT)
    a, k = calls[-1]
    with _spy(tsweeps, "advance") as t_adv:
        got = tsweeps.pair_toi(*a, **k)
    with _spy(psweeps, "advance") as p_adv:
        was = psweeps.pair_toi(*a, **k)
    cs._require(torch.equal(got, was), f"{label}: pair_toi differs from the earlier commit's")
    rec, iters, miss = _advance_args(t_adv[-1])
    x, p_iters, p_miss = _advance_args(p_adv[-1])
    out = dict(
        pairs=int(a[2].shape[0]), live=int(a[4].sum()),
        pass_events=dict(parent=_profile(lambda: psweeps.pair_toi(*a, **k)),
                         current=_profile(lambda: tsweeps.pair_toi(*a, **k))),
        k8_events=dict(parent=_profile(lambda: psweeps.conservative_advance(x, p_iters,
                                                                             p_miss)),
                       current=_profile(lambda: tsweeps.conservative_advance(rec, iters,
                                                                            miss))),
        pass_ms=_turns(lambda f: _synced_median(f, reps), lambda: psweeps.pair_toi(*a, **k),
                       lambda: tsweeps.pair_toi(*a, **k)))
    print(f"[k8 {label}] one pair_toi call ({out['pairs']} slots, {out['live']} live), bit "
          f"for bit equal to the earlier commit's; CUDA events and device ms of the pass "
          f"{out['pass_events']}, of the K8 wrapper {out['k8_events']}; synced ms of the "
          f"pass {out['pass_ms']}")
    return out


def ccd_steps(dev, pair_toi, steps=48):
    narrowphase.pair_toi, real = pair_toi, narrowphase.pair_toi
    try:
        sim, _, _ = cs.ccd_world(4096, cs.CCD_SPHERES, dev, 16384)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(steps, DT)
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0), sim.state_hash()
    finally:
        narrowphase.pair_toi = real


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_vs_parent: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name, smi = torch.cuda.get_device_name(0), cs._nvidia_smi()
    print(f"[k8 device] {name} ({smi})")
    psweeps = load_parent(args.parent)
    result = dict(device=name, nvidia_smi=smi)
    result["phase33"] = phase33_call(dev, psweeps, args.reps)
    sim, _, _ = cs.ccd_world(4096, cs.CCD_SPHERES, dev, 16384)
    result["phase35_call"] = ccd_call("phase 35", sim, 8, psweeps, args.reps)
    del sim
    tank, _ = cs.vehicle_world("tank", dev)
    result["tank_call"] = ccd_call("tank", tank, 10, psweeps, args.reps)
    del tank
    runs = {"parent": [], "current": []}
    for who in ("parent", "current", "current", "parent"):
        runs[who].append(ccd_steps(dev, psweeps.pair_toi if who == "parent"
                                   else tsweeps.pair_toi))
    hashes = {h for v in runs.values() for _, h in v}
    cs._require(len(hashes) == 1, "phase 35's scene differs between the two pair_toi")
    result["phase35_steps_per_s"] = {k: [s for s, _ in v] for k, v in runs.items()}
    print(f"[k8 phase 35] steps/s over 48 timed steps, in turns: "
          f"{result['phase35_steps_per_s']}; one state_hash {hashes.pop():#018x}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
