"""Where one step of the port goes on one CUDA card, for one of five scenes after
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
- ``--scene colosseum``: ``bench.py``'s colosseum (``--bodies 23040`` by default: grid2,
  the windowed layout, K2; or 2880: brute force, K1) through ``models.run_colosseum``'s
  sequence up to the settled state, profiled twice: the settled window (islands asleep),
  then, after the topple of colosseum 0, the churn window;
- ``--scene cloth``: the 64 x 64 cloth of ``chip_smoke.py`` phase 27 after its 64 steps
  over the sphere, the general path through K3;

then

1. a synced host-clock time per stage (each stage wrapped in ``torch.cuda.synchronize``),
   over ``--steps`` steps;
2. the unsynced step time over the same number of steps;
3. ``torch.profiler`` over the same number of unsynced steps: device time (kernel events),
   kernels and contact-kernel launches per step (counted), the contact kernel's own
   device time per step, the device's idle share of that profiled window (1 - device
   time / its wall time, the profiler's own host cost included), and the kernels that
   take the most device time.

    python3 chip_profile.py [--scene tube|ragdoll_pile|pile|colosseum|cloth] [--ragdolls N]
                            [--steps 5] [--settings bench|default]
                            [--bodies 16384|4096|23040|2880] [--schedule]

Prints one JSON object as its last line and writes it to
``build/profile_<scene>_<settings>.json`` (``profile_pile4096_bench.json`` for the 4,096-body
pile, ``profile_pile_schedule.json`` with ``--schedule``, ``profile_colosseum23040_bench.json``
with the settled and churn windows under ``windows``).
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


def measure(sim, steps, kernel, grid2, pile, small, schedule, is_pile):
    """The three measurements of the module docstring over ``steps`` steps of ``sim``."""
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.solver import solve as tsolve

    # 1. Synced stage times. Stages called from the step (``simulation``) and, inside the
    # solve, the coloring and layout, the contact kernel, and the joint sweeps are timed
    # apart.
    stages = defaultdict(float)
    patches = [(tsim, n) for n in ("compute_body_bounds", "narrow_phase_store",
                                   "narrow_phase_compound", "wake_touched", "solve_all",
                                   "update_sleep", "update_cache_keyed", "retain_sleeping_when")]
    patches += [(tsim.bp, "grid2" if grid2 else "brute_force"), (tsim.pairstore, "update"),
                (tsolve.bk_mod, "color_table"), (tsolve.psweep, kernel)]
    if pile or (schedule and grid2):
        patches.append((tsolve, "_win_store_bucket"))
    elif is_pile and not small:
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
        sim.run(steps, DT)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / steps * 1e3
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    stage_ms = {k: v / steps * 1e3 for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}

    # 2. Unsynced step time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps, DT)
    torch.cuda.synchronize()
    unsynced = (time.perf_counter() - t0) / steps * 1e3

    # 3. Profiler: device time, launches, idle share, all of the profiled window.
    from torch.profiler import ProfilerActivity, profile

    counted = getattr(tsolve.psweep, kernel)
    before = counted.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps, DT)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    launches = counted.launches - before
    # Kernel events only: an operator's event carries its kernels' device time as well.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    symbol = f"::{kernel.removeprefix('solve_')}_kernel("  # e.g. ::contact_sweep_kernel(
    own = [e for e in kernels if symbol in e.key]
    kernel_ms = sum(e.self_device_time_total for e in own) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    awake = float(sim.state.bodies.awake.float().mean())
    return dict(
        contacts=int(sim.last_diag.contact_count), awake_share=awake,
        synced_ms_per_step=synced, stage_ms=stage_ms, unsynced_ms_per_step=unsynced,
        profiled_ms_per_step=wall, device_ms_per_step=device_ms,
        idle_share_profiled=1.0 - device_ms / wall,
        kernels_per_step=sum(e.count for e in kernels) / steps,
        kernel=kernel, kernel_launches_per_step=launches / steps,
        kernel_device_ms_per_step=kernel_ms,
        top_kernels=[(e.key[:70], e.self_device_time_total / 1e3 / steps,
                      e.count // steps) for e in top],
    )


def main():
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("tube", "ragdoll_pile", "pile", "colosseum", "cloth"),
                    default="tube")
    ap.add_argument("--ragdolls", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--settings", choices=("bench", "default"), default="bench")
    ap.add_argument("--bodies", type=int, choices=(16384, 4096, 23040, 2880), default=None)
    ap.add_argument("--schedule", action="store_true")
    args = ap.parse_args()

    import chip_smoke

    dev = torch.device("cuda")
    smi = chip_smoke._nvidia_smi()
    if args.bodies is None:
        args.bodies = 23040 if args.scene == "colosseum" else 16384
    pile = args.scene == "ragdoll_pile"
    small = args.scene in ("pile", "colosseum") and args.bodies <= 8192  # K1's whole solve
    grid2 = args.scene not in ("tube", "cloth") and not small
    settle = max(31, int(6 * 4096 ** (1 / 3)))
    scene = f"pile{args.bodies}" if small and args.scene == "pile" else args.scene
    topple = None
    if args.scene == "colosseum":
        from bepuphysics2_tpu_torch.models import awake_fraction, build_colosseum_sim

        n_rag, settings, scene = 0, "bench", f"colosseum{args.bodies}"
        sim, _, handles, col_of = build_colosseum_sim(args.bodies, device=dev)
        kernel = "solve_substeps_contacts" if small else "solve_substeps_contacts_win"

        def topple():
            for h in [h for h, c in zip(handles, col_of) if c == 0]:
                v = sim.get_body(int(h))[2]
                sim.set_velocity(int(h), linear=(float(v[0]) + 4.0, float(v[1]), float(v[2])))
    elif args.scene == "cloth":
        from bepuphysics2_tpu_torch.models import build_cloth_sim

        n_rag, settings, kernel = 0, "default", "contact_sweep"
        sim = build_cloth_sim(chip_smoke.CLOTH, chip_smoke.CLOTH, device=dev)[0]
    elif pile:
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
    if args.scene == "colosseum":  # models.run_colosseum's sequence up to the settled window
        sim.run(33, DT)
        sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        sim.run(33, DT)
        for _ in range(20):
            sim.run(30, DT)
            if awake_fraction(sim) < 0.05:
                break
    elif args.scene == "cloth":
        sim.run(64, DT)
    elif small:
        sim.run(33 + 96, DT)
    else:
        sim.run(33, DT)
        sim.run(settle, DT)
        sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        sim.run(33, DT)
    torch.cuda.synchronize()

    windows = {}
    for window in (("settled", "churn") if topple else ("steady",)):
        if window == "churn":
            topple()
            sim.run(1, DT)  # the step that wakes the colosseum, outside the measurement
            torch.cuda.synchronize()
        windows[window] = measure(sim, args.steps, kernel, grid2, pile, small, args.schedule,
                                  args.scene == "pile")
    out = dict(card=smi, scene=scene, ragdolls=n_rag, settings=settings, bodies=sim.body_count,
               steps=args.steps, **(windows["steady"] if "steady" in windows
                                    else dict(windows=windows)))
    os.makedirs("build", exist_ok=True)
    with open(f"build/profile_{scene}_{settings}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
