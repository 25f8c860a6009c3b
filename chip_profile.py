"""Where one step of the port goes on one CUDA card, for one of three scenes after
``bench.py``'s warm-up and autosize:

- ``--scene tube`` (default): the ragdoll tube (32 ragdolls by default; at ``bench.py``'s
  solver settings, or with ``--settings default`` at the package's defaults, where its
  limbs stay inside), the general path through K3;
- ``--scene ragdoll_pile``: the ragdoll pile (1,024 ragdolls by default, 16 colors,
  above 8,192 bodies: grid2 and the windowed layout), through K4;
- ``--scene pile``: the 16,384-body mixed pile (``bench.py``'s scene and sequence: 33
  steps, 152 settle, autosize, 33), the store fast path on the windowed layout through K2;
  with ``--bodies 4096``, the 4,096-body pile of ``chip_smoke.py`` phase 4 (its 33 + 96
  steps, no autosize), the store fast path through K1; with ``--schedule``, the pile of
  ``chip_smoke.py`` phase 23 (4,096 bodies: the iteration schedule and the velocity
  callback, the substep loop through K3) or phase 24 (16,384 bodies: the schedule and
  its capacities, the substep loop through K4);

then

1. a synced host-clock time per stage (each stage wrapped in ``torch.cuda.synchronize``),
   over ``--steps`` steps;
2. the unsynced step time over the same number of steps;
3. ``torch.profiler`` over the same number of unsynced steps: device time (kernel events),
   kernels and contact-kernel launches per step (counted), the contact kernel's own
   device time per step, the device's idle share of that profiled window (1 - device
   time / its wall time, the profiler's own host cost included), and the kernels that
   take the most device time.

    python3 chip_profile.py [--scene tube|ragdoll_pile|pile] [--ragdolls N] [--steps 5]
                            [--settings bench|default] [--bodies 16384|4096] [--schedule]

Prints one JSON object as its last line and writes it to
``build/profile_<scene>_<settings>.json`` (``profile_pile4096_bench.json`` for the 4,096-body
pile, ``profile_pile_schedule.json`` with ``--schedule``).
Needs a card; imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

DT = 1.0 / 60.0


def _timed(table, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        table[name] += time.perf_counter() - t0
        return out

    return wrapper


def main():
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("tube", "ragdoll_pile", "pile"), default="tube")
    ap.add_argument("--ragdolls", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--settings", choices=("bench", "default"), default="bench")
    ap.add_argument("--bodies", type=int, choices=(16384, 4096), default=16384)
    ap.add_argument("--schedule", action="store_true")
    args = ap.parse_args()

    import chip_smoke
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.solver import solve as tsolve

    dev = torch.device("cuda")
    smi = chip_smoke._nvidia_smi()
    pile = args.scene == "ragdoll_pile"
    small = args.scene == "pile" and args.bodies <= 8192  # the store fast path through K1
    grid2 = args.scene != "tube" and not small
    settle = max(31, int(6 * 4096 ** (1 / 3)))
    scene = f"pile{args.bodies}" if small else args.scene
    if pile:
        from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim

        n_rag = args.ragdolls or chip_smoke.PILE_RAGDOLLS
        sim, _ = build_ragdoll_pile_sim(n_rag, device=dev)
        settings, kernel = "default", "contact_sweep_win"
    elif args.scene == "pile":
        n_rag = 0
        overrides = {}
        if args.schedule:  # chip_smoke.py phase 23 or 24
            overrides = chip_smoke._schedule_overrides(callback=small)
            overrides.update({} if small else chip_smoke.SCHEDULE_16K_CAPS)
        sim = chip_smoke.build_pile(args.bodies, dev, **overrides)
        settle = max(31, int(6 * args.bodies ** (1 / 3)))
        settings = "schedule" if args.schedule else "bench"
        kernel = {(True, False): "solve_substeps_contacts",
                  (False, False): "solve_substeps_contacts_win",
                  (True, True): "contact_sweep",
                  (False, True): "contact_sweep_win"}[small, args.schedule]
    else:
        n_rag = args.ragdolls or 32
        sim = chip_smoke.tube_sim(n_rag, dev, bench=args.settings == "bench")
        settings, kernel = args.settings, "contact_sweep"
    if small:
        sim.run(33 + 96, DT)
    else:
        sim.run(33, DT)
        sim.run(settle, DT)
        sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        sim.run(33, DT)
    torch.cuda.synchronize()

    # 1. Synced stage times. Stages called from the step (``simulation``) and, inside the
    # solve, the coloring and layout, the contact kernel, and the joint sweeps are timed
    # apart.
    stages = defaultdict(float)
    patches = [(tsim, n) for n in ("compute_body_bounds", "narrow_phase_store",
                                   "narrow_phase_compound", "wake_touched", "solve_all",
                                   "update_sleep", "update_cache_keyed", "retain_sleeping_when")]
    patches += [(tsim.bp, "grid2" if grid2 else "brute_force"), (tsim.pairstore, "update"),
                (tsolve.bk_mod, "color_table"), (tsolve.psweep, kernel)]
    if pile or (args.schedule and grid2):
        patches.append((tsolve, "_win_store_bucket"))
    elif args.scene == "pile" and not small:
        patches.append((tsolve, "win_pack"))
    saved = [(mod, n, getattr(mod, n)) for mod, n in patches]
    for mod, n, fn in saved:
        wrapped = _timed(stages, f"{mod.__name__.split('.')[-1]}.{n}", fn)
        if n == kernel:
            wrapped.launches = 0  # the kernel's wrapper counts its launches on this name
        setattr(mod, n, wrapped)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(args.steps, DT)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / args.steps * 1e3
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    stage_ms = {k: v / args.steps * 1e3 for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}

    # 2. Unsynced step time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(args.steps, DT)
    torch.cuda.synchronize()
    unsynced = (time.perf_counter() - t0) / args.steps * 1e3

    # 3. Profiler: device time, launches, idle share, all of the profiled window.
    from torch.profiler import ProfilerActivity, profile

    counted = getattr(tsolve.psweep, kernel)
    before = counted.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(args.steps, DT)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps * 1e3
    launches = counted.launches - before
    # Kernel events only: an operator's event carries its kernels' device time as well.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    symbol = f"::{kernel.removeprefix('solve_')}_kernel("  # e.g. ::contact_sweep_kernel(
    own = [e for e in kernels if symbol in e.key]
    kernel_ms = sum(e.self_device_time_total for e in own) / 1e3 / args.steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(
        card=smi, scene=scene, ragdolls=n_rag, settings=settings, bodies=sim.body_count,
        steps=args.steps, contacts=int(sim.last_diag.contact_count),
        synced_ms_per_step=synced, stage_ms=stage_ms, unsynced_ms_per_step=unsynced,
        profiled_ms_per_step=wall, device_ms_per_step=device_ms,
        idle_share_profiled=1.0 - device_ms / wall,
        kernels_per_step=sum(e.count for e in kernels) / args.steps,
        kernel=kernel, kernel_launches_per_step=launches / args.steps,
        kernel_device_ms_per_step=kernel_ms,
        top_kernels=[(e.key[:70], e.self_device_time_total / 1e3 / args.steps,
                      e.count // args.steps) for e in top],
    )
    os.makedirs("build", exist_ok=True)
    with open(f"build/profile_{scene}_{settings}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
