"""Smoke run of the PyTorch port on one CUDA card: builds kernels K1 and K2 from the
repository's sources, holds each against its plain PyTorch version at its main path's
shapes, then drives the port's two main paths through ``Simulation`` as ``bench.py``
does and checks what comes out: the 4,096-body mixed pile (brute-force broad phase, K1)
and the 16,384-body pile (grid2 broad phase, autosize, the windowed K2).

    python3 chip_smoke.py

Each phase prints one line; any failure raises, so the script exits non-zero and prints
no result. The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel of the path with its launch count on the main path, its error against the
plain version, and both times. Imports nothing of JAX: the machine with the card has none.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

DT = 1.0 / 60.0
K1_SOURCE = "bepuphysics2_tpu_torch/csrc/substeps_contacts.cu"
K1_REPLACES = "bepuphysics2_tpu/ops/sweep.py:486"
K1_TOL = 1e-4  # FMA contraction and the kernel's Jacobi summation order, over 4 substeps
K2_SOURCE = "bepuphysics2_tpu_torch/csrc/substeps_contacts_win.cu"
K2_REPLACES = "bepuphysics2_tpu/ops/sweep.py:1201"
K2_TOL = 1e-4  # as K1
WIN_TOL = (2e-2, 1e-3)  # the JAX package's envelope for its windowed kernel (max, median)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_pile(n_bodies, device, **overrides):
    """The mixed sphere/box pile on a static box ground, as ``__graft_entry__.
    _build_pile_sim`` builds it (seed 7), with ``bench.py``'s capacities and solver
    settings (16 colors above 8,192 bodies)."""
    from bepuphysics2_tpu_torch import (
        BodyDescription, Box, SimConfig, Simulation, Sphere, StaticDescription,
    )

    config = SimConfig(**{**dict(
        body_capacity=n_bodies + 64, max_pairs=max(8 * n_bodies, 4096),
        substeps=4, num_colors=16 if n_bodies > 8192 else 8, broadphase="auto",
        color_cap_factor=1.0, jacobi_cap_factor=0.3, color_rounds=1,
    ), **overrides})
    sim = Simulation(config, device=device)
    ground = sim.add_shape(Box(100.0, 0.5, 100.0))
    sphere, box = Sphere(0.5), Box(0.5, 0.5, 0.5)
    sphere_id, box_id = sim.add_shape(sphere), sim.add_shape(box)
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    rng = np.random.default_rng(7)
    side = max(1, int(np.ceil(n_bodies ** (1 / 3))))
    n = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if n >= n_bodies:
                    break
                p = ((ix - side / 2) * 1.2 + rng.uniform(-0.05, 0.05), 1.0 + iy * 1.2,
                     (iz - side / 2) * 1.2 + rng.uniform(-0.05, 0.05))
                sid, obj = (sphere_id, sphere) if n % 2 == 0 else (box_id, box)
                sim.add_body(BodyDescription.dynamic(p, sid, 1.0, obj))
                n += 1
    return sim


def small_pile(device, **overrides):
    """The 24-body pile of the JAX package's kernel-equivalence tests, sleep on."""
    from bepuphysics2_tpu_torch import (
        BodyDescription, Box, SimConfig, Simulation, Sphere, StaticDescription,
    )

    sim = Simulation(SimConfig(body_capacity=64, max_pairs=256, substeps=2, num_colors=4,
                               velocity_iterations=2, enable_sleep=True, **overrides),
                     device=device)
    ground = sim.add_shape(Box(20.0, 0.5, 20.0))
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = Sphere(0.5), Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        y = 0.6 + 0.85 * (i // 8)
        sim.add_body(BodyDescription.dynamic((x, y, z), *((ss, 1.0, s) if i % 2 == 0
                                                          else (bs, 1.0, b))))
    return sim


def positions(sim):
    sim._sync_from_device()
    h = sim._host
    return np.stack([h.px, h.py, h.pz])


def _k1_outputs(out):
    v6, pos, orn, imp = out
    return [v6, torch.stack(list(pos)), torch.stack(list(orn)), imp]


def _time_ms(fn, reps):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    _require(torch.cuda.is_available(), "no CUDA device: this script runs only on a card")
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[1 device] {name} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}")
    print(smi)
    return name, smi


def phase_build():
    """Both kernels, one nvcc each, started together; K1 and K2 share contact_rows.cuh."""
    from bepuphysics2_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.load_all(["substeps_contacts", "substeps_contacts_win"])
    wall = time.perf_counter() - t0
    for label, name in (("K1", "substeps_contacts"), ("K2", "substeps_contacts_win")):
        report = [ln.strip() for ln in build.build_log(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[2 build] {label} built for sm_90a in {built[name][1]:.2f} s "
              f"(both in {wall:.2f} s); ptxas: {' | '.join(report)}")


def _hold(label, kern, plain, v6_in, tol):
    """Run the kernel and its plain version on the same inputs and hold them together:
    finite, the velocities moved, within ``tol``, bit-identical on a second kernel run.
    Returns (max |diff|, ms of the plain call on the host clock)."""
    got = _k1_outputs(kern())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _k1_outputs(plain())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for t in got:
        _require(bool(torch.isfinite(t).all()), f"{label} produced a non-finite value")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    _require(float((got[0] - v6_in).abs().max()) > 1e-3, f"{label} left the velocities unchanged")
    again = _k1_outputs(kern())
    _require(all(bool(torch.equal(g, a)) for g, a in zip(got, again)),
             f"{label} is not deterministic run to run")
    _require(err <= tol, f"{label} disagrees with its plain version: {err} > {tol}")
    return err, plain_ms


def phase_kernel(dev):
    """K1 against its plain version at the pile's shapes: 4,160 bodies, 64 slices of 512
    rows (48 colored, 16 Jacobi = 25%), 4 substeps, 1 iteration."""
    from bepuphysics2_tpu_torch.ops import sweep

    bank = sweep.synthetic_bank(4160, 512, n_colored=48, n_jacobi=16, seed=1, substeps=4)
    args = sweep.bank_args(bank, dev)
    kw = dict(sb=512, n_substeps=4, n_iters=1, angular_mode=0, gravity=(0.0, -10.0, 0.0))
    kern = lambda: sweep.solve_substeps_contacts(*args, **kw)
    plain = lambda: sweep._solve_substeps_contacts_plain(*args, **kw)
    err, _ = _hold("K1", kern, plain, args[0], K1_TOL)
    ms = _time_ms(kern, 20)
    plain_ms = _time_ms(plain, 3)
    print(f"[3 kernel] K1 vs plain at NB 4160, B 32768, sb 512, 4 substeps, 25% Jacobi "
          f"slices: max |diff| {err:.3e} (limit {K1_TOL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def _count_host_syncs(sim, steps):
    """Synchronising PyTorch calls per step, as the CUDA sync debug mode reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.run(steps, DT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / steps


def phase_main_path(dev, name, smi):
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC

    t0 = time.perf_counter()
    sim = build_pile(4096, dev)
    _require(sim.config.body_capacity == 4160 and sim.config.max_pairs == 32768,
             "pile configuration drifted from bench.py's")
    sweep.solve_substeps_contacts.launches = 0
    sim.run(33, DT)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t1 = time.perf_counter()
    sim.run(96, DT)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = sweep.solve_substeps_contacts.launches
    diag = sim.last_diag
    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "non-finite state")
    dyn = st.bodies.kind == KIND_DYNAMIC
    min_y = float(st.bodies.pos.y[dyn].min())
    _require(min_y > -0.2, f"a dynamic body fell through the ground (y = {min_y})")
    _require(not bool(diag.overflow), f"overflow (src {int(diag.overflow_src)})")
    pairs, contacts = int(diag.pair_count), int(diag.contact_count)
    _require(pairs > 0 and contacts > 0, "no pairs or no contacts in the pile")
    _require(launches == 33 + 96, f"K1 launched {launches} times in 129 steps")
    syncs = _count_host_syncs(sim, 4)
    sps = 96 / elapsed
    jac = int(diag.demand[5])
    print(f"[4 main path] 4096-body pile, 33 + 96 steps on {name} ({smi}): "
          f"{sps:.2f} steps/s over the 96 timed steps; warm-up {warm:.1f} s; pairs {pairs}, "
          f"contacts {contacts}, peak Jacobi rows {jac}, min dynamic y {min_y:.3f}, "
          f"K1 launches {launches} (one per step), host syncs per step {syncs:g}")
    return launches


def phase_determinism(dev, tag="5 determinism", path="", **overrides):
    hashes = []
    for _ in range(2):
        sim = build_pile(512, dev, **overrides)
        sim.run(60, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    print(f"[{tag}] 512-body pile{path}, 60 steps twice: state_hash {hashes[0]:#018x} "
          f"/ {hashes[1]:#018x}")
    _require(hashes[0] == hashes[1], "two identical runs on the card differ")


def phase_cpu_vs_card(dev, tag="6 cpu vs card", path="", tol=(5e-3, 1e-4), **overrides):
    runs = {}
    for d in ("cpu", dev):
        sim = small_pile(d, **overrides)
        sim.run(20, DT)
        runs[str(d)] = positions(sim)
    diff = np.abs(runs["cpu"] - runs[str(dev)])
    print(f"[{tag}] 24-body pile{path}, 20 frames: max |dpos| {diff.max():.3e} "
          f"(limit {tol[0]:g}), median {np.median(diff):.3e} (limit {tol[1]:g})")
    _require(diff.max() <= tol[0] and np.median(diff) <= tol[1],
             "the card and the CPU disagree beyond the reference's own envelope")


def phase_kernel_win(dev):
    """K2 against its plain version on a synthetic windowed bank at the 16k pile's shapes:
    16,448 bodies, a 140,288-row bank (the capacity autosize gives the pile) two-thirds
    full, 16 colors, a tenth of the rows joining far bodies, 4 substeps, 1 iteration."""
    from bepuphysics2_tpu_torch.ops import sweep

    t0 = time.perf_counter()
    bank = sweep.synthetic_win_bank(16448, 140288, 16, seed=2, substeps=4, wide_frac=0.1,
                                    fill=0.66)
    made = time.perf_counter() - t0
    args = sweep.win_bank_args(bank, dev)
    kw = dict(sb=bank["sb"], n_substeps=4, n_iters=1, angular_mode=0, gravity=(0.0, -10.0, 0.0))
    kern = lambda: sweep.solve_substeps_contacts_win(*args, **kw)
    plain = lambda: sweep._solve_substeps_contacts_win_plain(*args, **kw)
    err, plain_ms = _hold("K2", kern, plain, args[0], K2_TOL)
    ms = _time_ms(kern, 5)
    print(f"[7 kernel] K2 vs plain at NP {bank['v6'].shape[0]}, BP {bank['bp']} "
          f"({bank['live_slices']} live slices of 256, {bank['wide_rows']} wide rows), "
          f"4 substeps: max |diff| {err:.3e} (limit {K2_TOL}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms; bit-identical repeat; bank built in {made:.1f} s")
    return err, ms, plain_ms


def phase_main_path_win(dev, name, smi):
    """The 16,384-body pile through bench.py's sequence: build, 33 steps, settle, autosize,
    33 steps, 96 timed steps. Every step must launch K2 once and K1 never; the plain K2
    must never run."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.simulation import D_ENTRIES, D_WIDE

    n = 16384
    warm, timed, settle = 33, 96, max(31, int(6 * n ** (1 / 3)))
    sim = build_pile(n, dev)
    c = sim.config
    _require((c.body_capacity, c.max_pairs, c.num_colors) == (16448, 131072, 16),
             "16k pile configuration drifted from bench.py's")
    plain_calls = []
    plain = sweep._solve_substeps_contacts_win_plain
    sweep._solve_substeps_contacts_win_plain = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    sweep.solve_substeps_contacts.launches = 0
    sweep.solve_substeps_contacts_win.launches = 0
    stages = []

    def run(steps):
        before = sweep.solve_substeps_contacts_win.launches
        sim.run(steps, DT)
        _require(sweep.solve_substeps_contacts_win.launches - before == steps,
                 f"K2 did not launch once per step over {steps} steps")

    try:
        t0 = time.perf_counter()
        run(warm)
        run(settle)
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        before = sweep.solve_substeps_contacts_win.launches
        sized = sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        probe = sweep.solve_substeps_contacts_win.launches - before
        _require(probe >= 32 and probe % 32 == 0, f"autosize ran {probe} steps off K2")
        run(warm)
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        import warnings

        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(timed)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
        syncs = sum("synchroniz" in str(w.message) for w in caught) / timed
    finally:
        sweep._solve_substeps_contacts_win_plain = plain
    k1, k2 = sweep.solve_substeps_contacts.launches, sweep.solve_substeps_contacts_win.launches
    steps = warm + settle + probe + warm + timed
    diag = sim.last_diag
    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "non-finite state")
    dyn = st.bodies.kind == KIND_DYNAMIC
    min_y = float(st.bodies.pos.y[dyn].min())
    demand = [int(x) for x in diag.demand]
    pairs, contacts = int(diag.pair_count), int(diag.contact_count)
    c = sim.config
    caps = dict(max_pairs=c.max_pairs, wide_cap_rows=c.wide_cap_rows, store_churn=c.store_churn,
                store_dead=c.store_dead, store_repair=c.store_repair,
                grid_entry_factor=c.grid_entry_factor, grid_max_large=c.grid_max_large,
                grid_cell_capacity=c.grid_cell_capacity, grid_pair_k=c.grid_pair_k)
    print(f"[8 main path] {n}-body pile, {warm} + {settle} settle + autosize ({probe} probe "
          f"steps, {sized['rounds']} rounds) + {warm} + {timed} steps on {name} ({smi}): "
          f"{timed / elapsed:.2f} steps/s over the {timed} timed steps; warm-up + settle "
          f"{stages[0]:.1f} s, to the timed window {stages[1]:.1f} s; pairs {pairs}, contacts "
          f"{contacts}, wide rows {demand[D_WIDE]}, grid entries {demand[D_ENTRIES]}, min "
          f"dynamic y {min_y:.3f}; demand {demand}; autosized {caps}; K2 launches {k2} in "
          f"{steps} steps, K1 launches {k1}, plain K2 calls {len(plain_calls)}; host syncs "
          f"per step {syncs:g}")
    _require(demand[D_ENTRIES] > 0, "the grid2 broad phase did not run")
    _require(k2 == steps and k1 == 0, "the 16k pile did not solve through K2 alone")
    _require(not plain_calls, "the plain K2 ran on the card's main path")
    _require(not bool(diag.overflow), f"overflow after autosize (src {int(diag.overflow_src)})")
    _require(min_y > -0.2, f"a dynamic body fell through the ground (y = {min_y})")
    _require(pairs > 0 and contacts > 0, "no pairs or no contacts in the pile")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    return k2


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    import bepuphysics2_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name, smi = phase_device()
    phase_build()
    err, ms, plain_ms = phase_kernel(dev)
    launches = phase_main_path(dev, name, smi)
    phase_determinism(dev)
    phase_cpu_vs_card(dev)
    err2, ms2, plain_ms2 = phase_kernel_win(dev)
    launches2 = phase_main_path_win(dev, name, smi)
    win = dict(solver_backend="pallas_win", broadphase="grid2")
    phase_determinism(dev, "9 determinism", " on the windowed path (grid2, K2)", **win)
    phase_cpu_vs_card(dev, "10 cpu vs card", " on the windowed path", WIN_TOL, **win)
    print(json.dumps({"kernels": [{
        "name": "solve_substeps_contacts (K1)", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    }, {
        "name": "solve_substeps_contacts_win (K2)", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": launches2, "max_abs_err": err2,
        "ms": ms2, "plain_ms": plain_ms2,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
