"""Smoke run of the PyTorch port on one CUDA card: builds kernels K1-K8 from the
repository's sources, holds each against its plain PyTorch version at its main path's
shapes, then drives the port's main paths through ``Simulation`` as ``bench.py`` does and
checks what comes out: the 4,096-body mixed pile (brute-force broad phase, K1: one
cooperative launch per step, each color's pages in parallel across the SMs), the
16,384-body pile (grid2 broad phase, autosize, the windowed K2: one cooperative launch per
step, each color's slices in parallel across the SMs), the ragdoll tube of 32
ragdolls (joints and a compound: the general path over K3) at bench.py's solver settings
and at the package's default ones, the pile of 1,024 ragdolls (the general path above
8,192 bodies: grid2, autosize, the windowed layout, K4, cooperative as K1 and K2) and the
contact-only compound pile (one K1 launch over the store's and the compound's banks). The
wave tables of K1-K4 are held to their contract on real steps. Then the TPU design
probes of ``experiments/`` through their entry points: the sweep prototypes v1-v4 (K5)
and the gather and scatter probes k1-k6 (K6, K7: one launch of a grid over row ranges).
Then the iteration schedule and the velocity callback, which take a store-only scene off
K1 and K2: the 4,096-body pile with both through K3 (its store's color waves several
pages of 512 rows each) and the 16,384-body pile with the schedule through K4. Last,
slice 10: ``bench.py``'s colosseum through its sequence, island sleep and wake under load
(2,880 bodies through K1, 23,040 through grid2 and K2), the 64 x 64 cloth over a sphere
(its contacts through K3 beside 16,002 joints) and every joint type (the 30-rig battery,
no host sync). Then slice 11: the 4,096-body pile of the reference's ShapePileBenchmark
mix (sphere, capsule, box, cylinder, convex hull; the generic GJK/MPR narrow phase beside
K1) and the car and the tank of ``tests/test_models.py``, each in its test's scene (K3).
Then slice 12: 4,096 bodies with compound dumbbells on a 7,200-triangle mesh (the compound
bank with compound-vs-compound records beside the store's, one K1 launch a step), every
scene query of ``Simulation`` on that pile held to a CPU copy of its state, and 64
characters on the mesh (K3). Then slice 13: the sweeps' and CCD's conservative
advancement in one hand-written kernel, K8 (two passes over factored records since slice
15, held bit for bit against its plain version on phase 33's own call and on phase 35's
last; a sweep or CCD pass with a registered custom shape type keeps the masked
PyTorch loop, replayed as a CUDA graph, and the phases here, which have none, are
required never to run it), CCD at full width (phase 35: 256 continuous spheres at 120
m/s through the 4,096-body pile toward a wall, K1 and K8 once a step) and the utilities
on phase 4's pile (phase 36: checkpoint and restore, ``validate``, ``simulation_metrics``,
``profile_stages``, ``TraceSession``). Then slice 14: the 4,096-body pile on the legacy
per-frame path (phase 37: K1 once a step over the per-frame color buckets; a 4-ragdoll
tube on it through K3), the sweep and grid broad phases on that pile (38: every step's
pair list equal to the CPU function's), eight batched 512-body worlds (39: each
bit-identical to a lone ``Simulation``) and the constraint-sharded step on one and on two
gloo ranks sharing the card (40: in processes of their own, bit-identical across world
sizes; the masked solve reaches no kernel). On the card the joint sweep and the generic narrow
phase replay as CUDA graphs from a layout's second call
(``bepuphysics2_tpu_torch/utils/replay.py``); no kernel K1-K8 runs inside one. The CPU
sides of the card-vs-CPU phases run in a process of their own while the card runs
(``_start_cpu_side``), as does phase 33's. Phases 32-33 and K8's hold run before phases
29-30; from there phase 31's car and tank, bound by the host's launches, step in a
process each on the card beside phases 29-30 and 34-40.

    python3 chip_smoke.py

Each phase prints one line, ending with the seconds since the start; any failure raises,
so the script exits non-zero and prints
no result. The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel of the paths with its launch count on its main path, its error against the
plain version, its time through its wrapper (``ms``), the plain version's time, its bound
(the least time the card could take for the same work), where one PyTorch call computes
the same function that call's time, for K1, K3, K4, K6, K7 and K8 the kernel's C entry
point alone (``kernel_ms``, null for the others), and for K1-K4 and K8 each path that
launches the kernel with its count (``launches_by_path``). Imports nothing of JAX: the machine with the
card has none.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DT = 1.0 / 60.0
K1_SOURCE = "bepuphysics2_tpu_torch/csrc/substeps_contacts.cu"
K1_REPLACES = "bepuphysics2_tpu/ops/sweep.py:486"
K1_TOL = 1e-4  # FMA contraction and the kernel's Jacobi summation order, over 4 substeps
K2_SOURCE = "bepuphysics2_tpu_torch/csrc/substeps_contacts_win.cu"
K2_REPLACES = "bepuphysics2_tpu/ops/sweep.py:1201"
K2_TOL = 1e-4  # as K1
K3_SOURCE = "bepuphysics2_tpu_torch/csrc/contact_sweep.cu"
K3_REPLACES = "bepuphysics2_tpu/ops/sweep.py:294"
K3_TOL = 1e-4  # as K1
K4_SOURCE = "bepuphysics2_tpu_torch/csrc/contact_sweep_win.cu"
K4_REPLACES = "bepuphysics2_tpu/ops/sweep.py:901"
K4_TOL = 1e-4  # as K1
K5_SOURCE = "bepuphysics2_tpu_torch/csrc/probe_sweep.cu"
K5_REPLACES = "experiments/pallas_sweep_proto.py:39"
K5_TOL = 1e-5  # K5 rounds as the plain version; index_add_'s atomics order repeated targets
K6_SOURCE = "bepuphysics2_tpu_torch/csrc/probe_gather.cu"
K6_REPLACES = "experiments/pallas_gather_probe.py:36"
K7_SOURCE = "bepuphysics2_tpu_torch/csrc/probe_scatter.cu"
K7_REPLACES = "experiments/pallas_gather_probe.py:93"
WIN_TOL = (2e-2, 1e-3)  # the JAX package's envelope for its windowed kernel (max, median)
_START = time.perf_counter()
_print = print


def print(*args, **kwargs):  # noqa: A001
    """A phase's line (one that starts with "[") ends with the seconds since the start."""
    if args and isinstance(args[0], str) and args[0].startswith("["):
        args = (f"{args[0]} (at {time.perf_counter() - _START:.0f} s)",) + args[1:]
    _print(*args, **kwargs)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (data sheet)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_pile(n_bodies, device, shapes=None, seed=7, floor=1.0, **overrides):
    """The mixed sphere/box pile on a static box ground, as ``__graft_entry__.
    _build_pile_sim`` builds it (seed 7), with ``bench.py``'s capacities and solver
    settings (16 colors above 8,192 bodies). ``shapes``: the shape objects the bodies take
    in turn (a sphere of radius 0.5 and a box of half extent 0.5 by default); ``seed``
    jitters the positions; ``floor`` is the height of the lowest layer's centres."""
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
    objs = shapes or (Sphere(0.5), Box(0.5, 0.5, 0.5))
    ids = [sim.add_shape(o) for o in objs]
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    rng = np.random.default_rng(seed)
    side = max(1, int(np.ceil(n_bodies ** (1 / 3))))
    n = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if n >= n_bodies:
                    break
                p = ((ix - side / 2) * 1.2 + rng.uniform(-0.05, 0.05), floor + iy * 1.2,
                     (iz - side / 2) * 1.2 + rng.uniform(-0.05, 0.05))
                k = n % len(objs)
                sim.add_body(BodyDescription.dynamic(p, ids[k], 1.0, objs[k]))
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


# K5 built with parts of its one-writer pass left out, to split a pass's time (phase 21):
# (label, K5_PARTS) as csrc/probe_sweep.cu defines them.
K5_PARTS = (("indices only", 0), ("no math", 6), ("no scatter", 5))


def phase_build():
    """Every kernel, and K5's breakdown variants, one nvcc each, started together; K1-K4
    share contact_rows.cuh and waves.cuh."""
    from bepuphysics2_tpu_torch.ops import build

    names = tuple(build.KERNELS.items())
    t0 = time.perf_counter()
    built = build.load_all([n for _, n in names],
                           [("probe_sweep", (f"K5_PARTS={k}",)) for _, k in K5_PARTS])
    wall = time.perf_counter() - t0
    for label, name in names:
        report = [ln.strip() for ln in build.build_log(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[2 build] {label} built for sm_90a in {built[name][1]:.2f} s "
              f"(all in {wall:.2f} s); ptxas: {' | '.join(report)}")
    print(f"[2 build] K5 breakdown variants (K5_PARTS {[k for _, k in K5_PARTS]}) built in "
          f"{max(v[1] for k, v in built.items() if '[' in k):.2f} s")


# --- bounds: the least time the card could take for a kernel's work -----------------------

_MOVES = {"view", "_unsafe_view", "select", "slice", "unsqueeze", "squeeze", "expand", "stack",
          "cat", "index", "unbind", "clone", "copy_", "_to_copy", "lift_fresh", "zeros",
          "zeros_like", "ones", "ones_like", "full", "full_like", "empty", "new_zeros",
          "scalar_tensor", "detach", "alias", "t", "transpose", "permute", "reshape", "split",
          "index_put_", "_local_scalar_dense", "repeat_interleave", "arange"}


def _ops_per_item(fn, *args):
    """Float operations ``fn`` does for one row (or one body): run it on one-row tensors
    under a dispatch counter and add up the elements of every op that computes (not the
    ones that only move or create data; an indexed add counts its source)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            out = func(*fargs, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name in ("index_add", "index_add_"):
                Count.n += fargs[3].numel()
            elif name not in _MOVES:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs if torch.is_tensor(o))
            return out

    with Count():
        fn(*args)
    return Count.n


def _row_ops():
    """(warm start, one velocity iteration, depth update) operations per row and the
    substep body block's per body, counted on the plain functions (``ops/sweep.py``)."""
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.utils.vec import Quat, Sym3, Vec3

    bank = sweep.synthetic_sweep_bank(8, 8, 1, 0, seed=3)
    v6, i7, ps_t, imp_t, idx2, scale, inv_h = sweep.sweep_bank_args(bank, "cpu")
    h = bank["h"]
    row = lambda solve: sweep._slice_pass(
        v6.clone(), i7, ps_t[:, :1].contiguous(), imp_t[:, :1].clone(), ps_t[18:22, :1],
        idx2[[0, 8]].reshape(1, 2).long(), scale[[0, 8]].reshape(1, 2), 0, 1, solve, inv_h)
    warm, solve = _ops_per_item(row, False), _ops_per_item(row, True)
    one = lambda: torch.ones(1)
    va = sweep._vel_of(v6[:1])
    depth = _ops_per_item(sweep._inc_depth_rows, ps_t[:, :1], ps_t[18:22, :1], va, va, h)
    body = _ops_per_item(
        sweep._pose_vel_inertia_block, torch.zeros(1, 6), torch.zeros(1, 7),
        Vec3(one(), one(), one()), Quat(0 * one(), 0 * one(), 0 * one(), one()), one(),
        Sym3(one(), 0 * one(), one(), 0 * one(), 0 * one(), one()),
        torch.ones(1, dtype=torch.bool), torch.ones(1, dtype=torch.bool), h, 1.0, 1.0,
        (0.0, -10.0, 0.0), 0, 1)
    return dict(warm=warm, solve=solve, depth=depth, body=body)


def _bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of the bytes over the memory rate and the
    float32 operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _live_bytes(live, *tensors):
    """Bytes of the bank tensors whose last dimension runs over the bank's slices in order
    (a row's columns, or its A and B sides slice by slice), over the slices the kernel
    runs (``live``, a bool per slice) only: the kernels skip the others unread."""
    n_live, n_slices = int(live.sum()), live.numel()
    return sum(t.numel() * t.element_size() // n_slices * n_live for t in tensors)


def _valid_slices(ps_t, sb):
    """Bool per slice: the slice holds a valid row (K1 and K3 skip the others)."""
    from bepuphysics2_tpu_torch.ops import sweep

    return (ps_t[sweep.PS_VALID].reshape(-1, sb) > 0.5).any(dim=1)


def _whole_solve_bound(args, rows, live, live_rows, n_substeps, n_iters, ops):
    """K1's and K2's bound: every input read once and every output written once, the
    per-row inputs (``args[i]`` for i in ``rows``) over the ``live`` slices alone; per
    substep each live row's warm start and iterations (and its depth update after the
    first) and each body's substep block."""
    tensors = [a for i, a in enumerate(args) if torch.is_tensor(a) and i not in rows]
    for a in args:
        if isinstance(a, tuple):
            tensors += list(a)
    v6, pos, orn, imp_t = args[0], args[1], args[2], args[8]
    nbytes = (_nbytes(*tensors) + _live_bytes(live, *(args[i] for i in rows))
              + _nbytes(v6, *pos, *orn, imp_t))
    nb = v6.shape[0]
    work = n_substeps * (live_rows * (ops["warm"] + n_iters * ops["solve"]) + nb * ops["body"])
    work += (n_substeps - 1) * live_rows * ops["depth"]
    return _bound(nbytes, work)


def _hold(label, kern, plain, v6_in, tol, outputs=_k1_outputs):
    """Run the kernel and its plain version on the same inputs and hold them together:
    finite, the velocities moved, within ``tol``, bit-identical on a second kernel run.
    Returns (max |diff|, ms of the plain call on the host clock)."""
    got = outputs(kern())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = outputs(plain())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for t in got:
        _require(bool(torch.isfinite(t).all()), f"{label} produced a non-finite value")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    _require(float((got[0] - v6_in).abs().max()) > 1e-3, f"{label} left the velocities unchanged")
    again = outputs(kern())
    _require(all(bool(torch.equal(g, a)) for g, a in zip(got, again)),
             f"{label} is not deterministic run to run")
    _require(err <= tol, f"{label} disagrees with its plain version: {err} > {tol}")
    return err, plain_ms


K4_ROWS = 111616  # phase 16's store rows when it runs alone (tools/k2_vs_parent.py)


def _clone_call(args, kw):
    """A copy of one recorded kernel call whose tensors no later step can change."""
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            items = [clone(y) for y in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    return clone(tuple(args)), {k: clone(v) for k, v in kw.items()}


def pile_k1_call(dev, steps=134):
    """The 4,096-body pile's K1 call of the step after ``steps`` steps, as (args, kw):
    by default phase 3's (phase 4's 129 steps, 4 counting host syncs, 1 more)."""
    sim = build_pile(4096, dev)
    sim.run(steps, DT)
    calls, _ = _k1_steps(sim, 1)
    return _clone_call(*calls[-1])


def k4_bank(n_rows, dev):
    """Phase 16's bank: K4's input at the ragdoll pile's shapes (10,256 body slots, 11
    Morton blocks), ``n_rows`` store rows, 16 colors, half the slots filled, a twentieth
    of the rows joining far bodies, one velocity iteration. Returns (bank, args, kw)."""
    from bepuphysics2_tpu_torch.ops import sweep

    bank = sweep.synthetic_win_bank(10 * PILE_RAGDOLLS + 16, n_rows, 16, seed=6, substeps=4,
                                    wide_frac=0.05, fill=0.5)
    return bank, sweep.sweep_win_bank_args(bank, dev), dict(sb=bank["sb"], n_iters=1)


def _bare_ms(name, call, reps):
    """CUDA-event ms of a kernel's C entry point alone (``csrc/<name>.cu``), on the
    arguments its wrapper makes: ``call`` runs the wrapper once, and inside it, while its
    tensors live, the entry point is launched ``reps`` more times and timed."""
    from bepuphysics2_tpu_torch.ops import build

    key = (name, f"{name}_launch")
    real = build._bound[key]
    out = {}

    def spy(*args):
        err = real(*args)
        out["ms"] = _time_ms(lambda: real(*args), reps)
        return err

    build._bound[key] = spy
    try:
        call()
    finally:
        build._bound[key] = real
    return out["ms"]


def _shape_note(name, sb, waves):
    from bepuphysics2_tpu_torch.ops import sweep

    n, color, tail, barriers = sweep.wave_shape(waves)
    grid = sweep.wave_grid(name, sb, (waves.shape[0] - 2) // 2)
    return (f"cooperative grid {grid} blocks of 512; per pass {n} waves: {len(color)} color "
            f"waves of {min(color, default=0)}-{max(color, default=0)} slices and {tail} "
            f"tail slices on one block, {barriers} grid barriers")


def phase_kernel(dev, call):
    """K1 against its plain version on the 4,096-body pile's own K1 call (``call``, phase
    4's last step: 4,160 bodies, 64 pages of 512 rows with their live and dead pages, 4
    substeps, 1 iteration). ``ms`` is the wrapper's call, ``kernel_ms`` its C entry point
    alone (``_bare_ms``)."""
    from bepuphysics2_tpu_torch.ops import sweep

    args, kw = call
    sb, ps_t = kw["sb"], args[7]
    kern = lambda: sweep.solve_substeps_contacts(*args, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "waves"}
    plain = lambda: sweep._solve_substeps_contacts_plain(*args, **plain_kw)
    err, plain_ms = _hold("K1", kern, plain, args[0], K1_TOL)
    ms = _time_ms(kern, 20)
    kernel_ms = _bare_ms("substeps_contacts", kern, 20)
    live = _valid_slices(ps_t, sb)
    live_rows = int((ps_t[sweep.PS_VALID] > 0.5).sum())
    bound_ms, bound_by = _whole_solve_bound(args, (7, 9, 10), live, live_rows,
                                            kw["n_substeps"], kw["n_iters"], _row_ops())
    print(f"[3 kernel] K1 vs plain on the 4096-body pile's own K1 call: NB {args[0].shape[0]}, "
          f"B {ps_t.shape[1]} ({ps_t.shape[1] // sb} pages of {sb}, {int(live.sum())} live), "
          f"{kw['n_substeps']} substeps, {kw['n_iters']} iteration: max |diff| {err:.3e} "
          f"(limit {K1_TOL}); {ms:.3f} ms through the wrapper (bodies packed, sort made), "
          f"the kernel alone {kernel_ms:.3f} ms; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}, {live_rows} live rows); "
          f"{_shape_note('substeps_contacts', sb, kw['waves'])}; bit-identical repeat")
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _timed_syncs(sim, steps):
    """Run ``steps`` steps under the CUDA sync debug mode. Returns (steps/s on the host
    clock, synchronising PyTorch calls per step as the mode reports them)."""
    import warnings

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.run(steps, DT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    return steps / elapsed, sum("synchroniz" in str(w.message) for w in caught) / steps


def _pile_gates(sim, label):
    """The pile's gates: every state value finite, no overflow, every dynamic body above
    y = -0.2, pairs and contacts. Returns (min y, pairs, contacts)."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC

    diag, st = sim.last_diag, sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega]
    leaves += ([st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw]
               if st.store is not None else  # the legacy path: the per-frame cache
               [st.cache.penetration, *st.cache.tangent, st.cache.twist])
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), f"{label}: non-finite state")
    min_y = float(st.bodies.pos.y[st.bodies.kind == KIND_DYNAMIC].min())
    _require(min_y > -0.2, f"{label}: a dynamic body fell through the ground (y = {min_y})")
    _require(not bool(diag.overflow), f"{label}: overflow (src {int(diag.overflow_src)})")
    pairs, contacts = int(diag.pair_count), int(diag.contact_count)
    _require(pairs > 0 and contacts > 0, f"{label}: no pairs or no contacts")
    return min_y, pairs, contacts


def _k1_steps(sim, steps):
    """Run ``steps`` steps of a K1 scene, recording every K1 call on the card and the
    inputs of every K1 wave table (``solver.solve.page_wave_table``). Returns (calls,
    tables)."""
    from bepuphysics2_tpu_torch.solver import solve as tsolve

    calls, restore = _capture_calls("solve_substeps_contacts")
    tables = []
    fn = tsolve.page_wave_table
    tsolve.page_wave_table = lambda *a: tables.append(a) or fn(*a)
    try:
        sim.run(steps, DT)
    finally:
        tsolve.page_wave_table = fn
        restore()
    return calls, tables


def _k1_structure(page_colors, valid, page, num_colors):
    """(live pages per color, the other live pages: Jacobi) of one K1 or K3 wave table's
    inputs (``solver.solve.page_wave_table``)."""
    live = valid.reshape(-1, page).any(1).cpu()
    col = torch.cat(list(page_colors)).cpu()
    per_color = [int((live & (col == c)).sum()) for c in range(num_colors)]
    return per_color, int(live.sum()) - sum(per_color)


def phase_main_path(dev, name, smi):
    """The 4,096-body pile through bench.py's sequence (33 steps, 96 timed): K1 once per
    step, no host sync; then two more steps whose K1 wave tables are held to their
    contract (``_table_check``), the last of which phase 3 holds K1 on. Returns (K1
    launches over the 129 steps, that K1 call)."""
    from bepuphysics2_tpu_torch.ops import sweep

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
    min_y, pairs, contacts = _pile_gates(sim, "the 4k pile")
    _require(launches == 33 + 96, f"K1 launched {launches} times in 129 steps")
    _, syncs = _timed_syncs(sim, 4)
    calls, tables = _k1_steps(sim, 2)
    _require(len(calls) == len(tables) == 2, f"{len(calls)} K1 calls in 2 steps")
    checked = [_table_check("K1", k["waves"].cpu(), *_k1_entries(a, k["sb"])) for a, k in calls]
    structure = _k1_structure(*tables[-1])
    sps = 96 / elapsed
    jac = int(diag.demand[5])
    print(f"[4 main path] 4096-body pile, 33 + 96 steps on {name} ({smi}): "
          f"{sps:.2f} steps/s over the 96 timed steps; warm-up {warm:.1f} s; pairs {pairs}, "
          f"contacts {contacts}, peak Jacobi rows {jac}, min dynamic y {min_y:.3f}, "
          f"K1 launches {launches} (one per step), host syncs per step {syncs:g}; structure "
          f"of the last step's page stream: live pages per color {structure[0]}, "
          f"{structure[1]} Jacobi pages; wave tables of 2 more steps: {_tables_note(checked)}"
          f", each color wave's written bodies named by no other row of the wave")
    _PILE["4k"] = sim  # phase 36 runs the utilities on it
    return launches, _clone_call(*calls[-1])


_PILE = {}


def phase_determinism(dev, tag="5 determinism", path="", steps=60, **overrides):
    """The 512-body pile, ``steps`` steps twice on the card: the same ``state_hash``."""
    hashes = []
    for _ in range(2):
        sim = build_pile(512, dev, **overrides)
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    print(f"[{tag}] 512-body pile{path}, {steps} steps twice: state_hash {hashes[0]:#018x} "
          f"/ {hashes[1]:#018x}")
    _require(hashes[0] == hashes[1], "two identical runs on the card differ")


def phase_cpu_vs_card(dev, tag="6 cpu vs card", path="", tol=(5e-3, 1e-4), n_bodies=None,
                      **overrides):
    """20 frames of a pile on the CPU and on the card, held to ``tol`` (max, median): the
    24-body pile, or ``build_pile(n_bodies)``."""
    sim = small_pile(dev, **overrides) if n_bodies is None else build_pile(n_bodies, dev,
                                                                            **overrides)
    sim.run(20, DT)
    # The CPU's 20 frames ran in the CPU-side process (``_start_cpu_side``).
    diff = np.abs(_cpu_result(tag.split()[0]) - positions(sim))
    print(f"[{tag}] {n_bodies or 24}-body pile{path}, 20 frames: max |dpos| {diff.max():.3e} "
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
    waves = torch.from_numpy(bank["waves"]).to(dev)
    kw = dict(sb=bank["sb"], n_substeps=4, n_iters=1, angular_mode=0, gravity=(0.0, -10.0, 0.0))
    kern = lambda: sweep.solve_substeps_contacts_win(*args, **kw, waves=waves)
    plain = lambda: sweep._solve_substeps_contacts_win_plain(*args, **kw)
    err, plain_ms = _hold("K2", kern, plain, args[0], K2_TOL)
    ms = _time_ms(kern, 5)
    live_rows = int((args[7][sweep.PS_VALID] > 0.5).sum())
    bound_ms, bound_by = _whole_solve_bound(args, (7, 9, 10, 11), args[12][:, 0] >= 0,
                                            live_rows, 4, 1, _row_ops())
    print(f"[7 kernel] K2 vs plain at NP {bank['v6'].shape[0]}, BP {bank['bp']} "
          f"({bank['live_slices']} live slices of 256, {bank['wide_rows']} wide rows), "
          f"4 substeps: max |diff| {err:.3e} (limit {K2_TOL}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms ({bound_by}, {live_rows} live rows); "
          f"{_shape_note('substeps_contacts_win', bank['sb'], waves)}; "
          f"bit-identical repeat; bank built in {made:.1f} s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _wave_check(wp, kind, num_colors):
    """Hold one step's K2 wave table (``solver.solve.win_pack``) to its contract: the
    waves cover the live slices in order; a wave of several slices is one color c < C of
    the narrow region, and its slices touch pairwise distinct dynamic bodies (every row
    side, padding included, through its slice's window); every other live slice is a
    wave of its own. Returns (waves, color waves, their largest)."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.ops import sweep

    sb = wp["ps_t"].shape[1] // wp["wseg"].shape[0]
    waves = sweep.wave_lists(wp["waves"])
    live = torch.nonzero(wp["wseg"][:, 0] >= 0).flatten().tolist()
    _require([sl for w in waves for sl in w] == live, "the waves do not cover the live "
             "slices in order")
    pos = sweep.window_positions(wp["whi2"], wp["wlo2"], wp["wseg"], sb).cpu().numpy()
    dyn_slot = np.append(kind.cpu().numpy() == KIND_DYNAMIC, False)
    dyn_pos = dyn_slot[wp["lay"]["pos_slot"].cpu().numpy()]
    gid = wp["rw"]["gid"].cpu().numpy()
    n_narrow, nblk = wp["rw"]["b_n"] // sb, wp["lay"]["nblk"]
    colored = lambda sl: sl < n_narrow and gid[sl] >= 0 and gid[sl] // nblk < num_colors
    multi = [w for w in waves if len(w) > 1]
    for w in waves:
        _require(len(w) == 1 or all(colored(sl) for sl in w), f"wave {w[:4]}... holds a "
                 "Jacobi or wide slice beside others")
    for w in multi:
        _require(len({gid[sl] // nblk for sl in w}) == 1, "a wave mixes colors")
        touched = np.concatenate([np.unique(pos[sl][dyn_pos[pos[sl]]]) for sl in w])
        _require(len(np.unique(touched)) == len(touched), f"two slices of the wave at slice "
                 f"{w[0]} touch one dynamic body")
    return len(waves), len(multi), max((len(w) for w in multi), default=0)


def _k1_entries(args, sb):
    """(positions, writing entries, valid entries, live slices) of a K1 call's bank on the
    host: entries (n_slices, 2 * sb), slices (n_slices,)."""
    from bepuphysics2_tpu_torch.ops import sweep

    inv_mass, lii, ps_t, idx2 = args[3], args[4], args[7], args[9]
    idx = idx2.reshape(-1, 2 * sb).long()
    valid = sweep.row_valid(ps_t, sb)
    writes = valid & ~sweep.body_still(inv_mass, lii)[idx]
    live = (ps_t[sweep.PS_VALID].reshape(-1, sb) > 0.5).any(1)
    return [t.cpu() for t in (idx, writes, valid, live)]


def _k4_entries(args, sb):
    from bepuphysics2_tpu_torch.ops import sweep

    it_t, ps_t, whi2, wlo2, wseg = args[1], args[2], args[4], args[5], args[7]
    pos = sweep.window_positions(whi2, wlo2, wseg, sb)
    return [t.cpu() for t in (pos, sweep.stream_writes(ps_t, it_t, sb),
                              sweep.row_valid(ps_t, sb), wseg[:, 0] >= 0)]


def _table_check(label, waves, pos, writes, valid, live):
    """Hold one step's K1 or K4 wave table to its contract (csrc/waves.cuh): the waves
    cover the live slices in order, and within a wave of several slices each written
    position (a valid row's side with inertia) is named by exactly one valid entry of the
    wave, so no two slices write one body and no slice reads what another writes. Returns
    (waves, color waves, their largest, tail slices)."""
    from bepuphysics2_tpu_torch.ops import sweep

    lists = sweep.wave_lists(waves)
    _require([sl for w in lists for sl in w] == torch.nonzero(live).flatten().tolist(),
             f"{label}: the waves do not cover the live slices in order")
    multi = [w for w in lists if len(w) > 1]
    for w in multi:
        named = pos[w][valid[w]]
        counts = torch.bincount(named, minlength=int(pos.max()) + 1)
        _require(bool((counts[pos[w][writes[w]]] == 1).all()), f"{label}: a body written in "
                 f"the wave at slice {w[0]} is named by another valid row of the wave")
    return len(lists), len(multi), max((len(w) for w in multi), default=0), len(lists) - len(multi)


def _tables_note(checked):
    return "; ".join(f"{w} waves, {c} color waves of at most {m} slices, {t} tail slices"
                     for w, c, m, t in checked)


def _capture_calls(fn_name):
    """Record every call of ``ops.sweep.<fn_name>`` on a CUDA tensor. Returns (calls,
    restore)."""
    from bepuphysics2_tpu_torch.ops import sweep

    fn = getattr(sweep, fn_name)
    calls = []

    def wrapped(*a, **k):
        if a[0].device.type == "cuda":
            calls.append((a, k))
        return fn(*a, **k)

    # The wrapper counts its launches on its module name, the wrapped function meanwhile.
    wrapped.launches = fn.launches
    setattr(sweep, fn_name, wrapped)

    def restore():
        fn.launches = wrapped.launches
        setattr(sweep, fn_name, fn)

    return calls, restore


def phase_main_path_win(dev, name, smi, timed=96):
    """The 16,384-body pile through bench.py's sequence: build, 33 steps, settle, autosize,
    33 steps, ``timed`` timed steps (bench.py: 96). Every step must launch K2 once and K1
    never; the plain K2 must never run. Two steps before the timed window hold each
    step's wave table to its contract (``_wave_check``)."""
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.simulation import D_ENTRIES, D_WIDE
    from bepuphysics2_tpu_torch.solver import solve as tsolve

    n = 16384
    warm, settle = 33, max(31, int(6 * n ** (1 / 3)))
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
        run(warm - 2)
        packs = []  # the last two steps' wave tables, held to their contract after them
        pack = tsolve.win_pack
        tsolve.win_pack = lambda *a, **k: packs.append((pack(*a, **k), a[1], a[8])) or packs[-1][0]
        try:
            run(2)
        finally:
            tsolve.win_pack = pack
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        checked = [_wave_check(wp, kind, ncol) for wp, kind, ncol in packs]
        _require(len(checked) == 2, f"{len(checked)} wave tables in 2 steps")
        sps, syncs = _timed_syncs(sim, timed)
    finally:
        sweep._solve_substeps_contacts_win_plain = plain
    k1, k2 = sweep.solve_substeps_contacts.launches, sweep.solve_substeps_contacts_win.launches
    steps = warm + settle + probe + warm + timed
    demand = [int(x) for x in sim.last_diag.demand]
    min_y, pairs, contacts = _pile_gates(sim, "the 16k pile after autosize")
    c = sim.config
    caps = dict(max_pairs=c.max_pairs, wide_cap_rows=c.wide_cap_rows, store_churn=c.store_churn,
                store_dead=c.store_dead, store_repair=c.store_repair,
                grid_entry_factor=c.grid_entry_factor, grid_max_large=c.grid_max_large,
                grid_cell_capacity=c.grid_cell_capacity, grid_pair_k=c.grid_pair_k)
    print(f"[8 main path] {n}-body pile, {warm} + {settle} settle + autosize ({probe} probe "
          f"steps, {sized['rounds']} rounds) + {warm} + {timed} steps on {name} ({smi}): "
          f"{sps:.2f} steps/s over the {timed} timed steps; warm-up + settle "
          f"{stages[0]:.1f} s, to the timed window {stages[1]:.1f} s; pairs {pairs}, contacts "
          f"{contacts}, wide rows {demand[D_WIDE]}, grid entries {demand[D_ENTRIES]}, min "
          f"dynamic y {min_y:.3f}; demand {demand}; autosized {caps}; K2 launches {k2} in "
          f"{steps} steps, K1 launches {k1}, plain K2 calls {len(plain_calls)}; host syncs "
          f"per step {syncs:g}; wave tables of the 2 steps before the timed window: "
          f"{'; '.join(f'{w} waves, {c} color waves of at most {m} slices' for w, c, m in checked)}"
          f", each color wave's slices on distinct dynamic bodies")
    _require(demand[D_ENTRIES] > 0, "the grid2 broad phase did not run")
    _require(k2 == steps and k1 == 0, "the 16k pile did not solve through K2 alone")
    _require(not plain_calls, "the plain K2 ran on the card's main path")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    return k2


# --- slice 3: the ragdoll tube, the general path over K3 --------------------------------

TUBE_AXIS = (0.0, 6.0)  # (x, y) of the tube's axis; radius 4.5
TUBE_REACH = 5.0  # radius plus margin: a dynamic body farther from the axis is outside


def tube_sim(n_ragdolls, device, substeps=4, num_colors=8, bench=True):
    """The ragdoll tube as ``__graft_entry__._build_ragdoll_tube_sim`` builds it, with
    ``bench.py``'s solver settings (color_cap_factor 1.0, jacobi_cap_factor 0.3,
    color_rounds 1) or, with ``bench=False``, the package's defaults (1.5, 0.3, 3)."""
    from bepuphysics2_tpu_torch.models import build_ragdoll_tube_sim

    sim, _ = build_ragdoll_tube_sim(n_ragdolls, substeps=substeps, num_colors=num_colors,
                                    device=device)
    if bench:
        sim.config = dataclasses.replace(sim.config, color_cap_factor=1.0,
                                         jacobi_cap_factor=0.3, color_rounds=1)
        sim._dirty = True
    return sim


def _inside(pos):
    """Per body of the (3, N) positions: within reach of the tube's axis and above y = 0."""
    return (np.hypot(pos[0] - TUBE_AXIS[0], pos[1] - TUBE_AXIS[1]) < TUBE_REACH) & (pos[1] > 0.0)


def _ragdolls_inside(state, n_rag):
    """Bool per body of ``state``: the ten bodies of every ragdoll that lies wholly inside
    the tube (ragdoll r holds bodies 1 + 10r to 10 + 10r)."""
    pos = np.stack([t.cpu().numpy() for t in state.bodies.pos])
    whole = _inside(pos)[1:1 + 10 * n_rag].reshape(n_rag, 10).all(axis=1)
    mask = np.zeros(pos.shape[1], bool)
    mask[1:1 + 10 * n_rag] = np.repeat(whole, 10)
    return torch.from_numpy(mask)


def _tube_shape(sim, n_rag):
    """(dynamic bodies outside the tube, of how many, min y, largest distance from the
    axis, head-torso distance of every ragdoll) of the simulation's current state."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC

    st = sim.state
    dyn = (st.bodies.kind == KIND_DYNAMIC).cpu().numpy()
    pos = np.stack([t.cpu().numpy() for t in st.bodies.pos])
    reach = np.hypot(pos[0] - TUBE_AXIS[0], pos[1] - TUBE_AXIS[1])
    outside = int((~_inside(pos))[dyn].sum())
    torso, head = 1 + 10 * np.arange(n_rag), 2 + 10 * np.arange(n_rag)
    apart = np.linalg.norm(pos[:, head] - pos[:, torso], axis=0)
    return outside, int(dyn.sum()), float(pos[1][dyn].min()), float(reach[dyn].max()), apart


def _card_steps_from_cpu(sim, dev, state, frames, held=None):
    """Carry the CPU state ``state`` through ``frames`` steps of ``sim``'s scene on the CPU
    (the kernels' plain versions); each frame, step the card from the CPU's state before
    it. Returns the largest |card - CPU| / (1 + |CPU|) over the pose and velocity of the
    bodies that ``held(state)`` selects before each step (every body by default), the
    same over every body, and the CPU's last state."""
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy

    cfg, present = sim.config, sim._present_types()
    scene = {d: (sim.shapes.device(d), sim._joint_banks(d)) for d in ("cpu", dev)}
    worst_held = worst_all = 0.0
    for _ in range(frames):
        mask = None if held is None else held(state)
        got, _ = tsim.step(state_from_numpy(state_to_numpy(state), dev), *scene[dev], DT,
                           cfg, present)
        state, _ = tsim.step(state, *scene["cpu"], DT, cfg, present)
        for f in ("pos", "orn", "vel", "omega"):
            for g, w in zip(getattr(got.bodies, f), getattr(state.bodies, f)):
                rel = (g.cpu() - w).abs() / (1.0 + w.abs())
                worst_all = max(worst_all, float(rel.max()))
                worst_held = max(worst_held, float(rel.max() if mask is None else rel[mask].max()))
    return worst_held, worst_all, state


# --- the CPU sides of the card-vs-CPU checks, in a process of their own -----------------

def _scene(builder, device):
    """The Simulation that ``builder`` (a function name of this module, of
    ``bepuphysics2_tpu_torch.models`` or of its ``joint_rigs``, its args, its kwargs)
    builds on ``device``."""
    import bepuphysics2_tpu_torch.models as models
    from bepuphysics2_tpu_torch.models import joint_rigs

    name, args, kwargs = builder
    fn = globals().get(name) or getattr(models, name, None) or getattr(joint_rigs, name)
    out = fn(*args, device=device, **kwargs)
    out = out[0] if isinstance(out, tuple) else out
    return getattr(out, "sim", out)


def _cpu_side_worker(jobs, results):
    """The CPU sides of the card-vs-CPU phases, run while the card runs its own phases:
    per job ``(key, builder, kind, warm, frames)``, the scene on the CPU, ``warm`` steps,
    then either its positions after ``frames`` steps (``kind`` "positions") or the
    ``frames + 1`` states of ``frames`` steps, each from the one before (``kind``
    "states", as numpy: ``state_to_numpy``). Puts ``(key, result)``; an exception as
    ``("error", text)``."""
    import traceback

    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.interop import state_to_numpy

    torch.set_num_threads(4)
    try:
        for key, builder, kind, warm, frames in iter(jobs.get, None):
            sim = _scene(builder, "cpu")
            sim.run(warm, DT)
            if kind == "positions":
                sim.run(frames, DT)
                results.put((key, positions(sim)))
                continue
            scene = (sim.shapes.device("cpu"), sim._joint_banks("cpu"), DT, sim.config,
                     sim._present_types())
            state = sim.state
            states = [state_to_numpy(state)]
            for _ in range(frames):
                state, _ = tsim.step(state, *scene)
                states.append(state_to_numpy(state))
            results.put((key, states))
    except Exception:  # noqa: BLE001  (handed to the main process, which raises)
        results.put(("error", traceback.format_exc()))


_CPU_SIDE = {}


def _start_cpu_side(keys=None):
    """Starts ``_cpu_side_worker`` on every CPU side of the run (or those of ``keys``), in
    the order the run takes them (phases 32 and 31 before phase 30)."""
    import multiprocessing as mp

    win = dict(solver_backend="pallas_win", broadphase="grid2")
    cloth = ("build_cloth_sim", (CLOTH_SMALL, CLOTH_SMALL), {})
    jobs_list = [
        ("6", ("small_pile", (), {}), "positions", 0, 20),
        ("10", ("small_pile", (), win), "positions", 0, 20),
        ("14", ("tube_sim", (2,), dict(substeps=2, num_colors=4)), "states", 0, 20),
        ("19", ("_small_ragdoll_pile", (), {}), "states", 0, 10),
        ("20", ("build_compound_pile_sim", (252,), {}), "states", 0, 10),
        ("23", ("build_pile", (512,), _schedule_overrides()), "positions", 0, 20),
        ("24", ("small_pile", (), {**_schedule_overrides(callback=False), **win}),
         "positions", 0, 20),
        ("27", cloth, "states", 0, 30),
        ("28", ("build_joint_rigs", (), dict(steps=0)), "states", 0, 3),
        ("32", ("build_terrain_pile_sim", (64, 10), {}), "states", 0, 10),
        ("31 car", ("vehicle_world", ("car",), {}), "states", 10, 3),
        ("31 tank", ("vehicle_world", ("tank",), {}), "states", 10, 3),
        ("30", ("build_pile", (256,), dict(shapes=five_shapes())), "positions", 0, 20),
        ("35", ("ccd_world", (64, 8), dict(ccd_pairs=512)), "states", 0, 10),
        ("37", ("build_pile", (256,), LEGACY), "positions", 0, 20),
        ("37t", ("legacy_tube", (4,), {}), "states", 0, 6),
    ]
    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    jobs.cancel_join_thread()  # a worker stopped early must not hold this process's exit
    worker = ctx.Process(target=_cpu_side_worker, args=(jobs, results), daemon=True)
    worker.start()
    for job in jobs_list:
        if keys is None or job[0] in keys:
            jobs.put(job)
    jobs.put(None)
    # The queues live as long as the worker: a queue collected here would take its
    # semaphore with it before the worker has started.
    _CPU_SIDE.update(worker=worker, jobs=jobs, results=results, got={})


def _stop_cpu_side():
    worker = _CPU_SIDE.get("worker")
    if worker is not None and worker.is_alive():
        worker.terminate()
        worker.join()


def _cpu_result(key):
    """The CPU side ``key`` from ``_cpu_side_worker`` (waiting for it if it is not done)."""
    import queue

    got = _CPU_SIDE["got"]
    while key not in got:
        try:
            k, v = _CPU_SIDE["results"].get(timeout=5)
        except queue.Empty:
            _require(_CPU_SIDE["worker"].is_alive(), f"the CPU-side process ended without {key}")
            continue
        _require(k != "error", f"a CPU side failed:\n{v}")
        got[k] = v
    return got.pop(key)


def _card_steps_from_states(sim, states):
    """Each of the CPU's steps (``states``, numpy, from ``_cpu_result``) stepped again on
    the card from the state before it, with ``sim``'s scene (built on the card): the
    largest |card - CPU| / (1 + |CPU|) over the bodies' poses and velocities, and the
    CPU's last state."""
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.interop import state_from_numpy

    dev = sim.device
    scene = (sim.shapes.device(dev), sim._joint_banks(dev), DT, sim.config,
             sim._present_types())
    worst = 0.0
    for before, after in zip(states, states[1:]):
        got, _ = tsim.step(state_from_numpy(before, dev), *scene)
        for f in ("pos", "orn", "vel", "omega"):
            for g, w in zip(getattr(got.bodies, f), getattr(after.bodies, f)):
                w = torch.from_numpy(np.asarray(w))
                worst = max(worst, float(((g.cpu() - w).abs() / (1.0 + w.abs())).max()))
    return worst, states[-1]


K3_COLORS = (6,) * 8  # phase 11's bank: 8 colors of 6 slices of 128 rows, 13 Jacobi slices
TUBE_K3_STEPS = 60  # the tube's steps (default settings) before tools/k2_vs_parent.py
                    # records its K3 calls


def k3_bank(dev):
    """Phase 11's bank: K3's input at the tube's compound-bank shapes (336 bodies, 61
    slices of 128 rows: 8 colors of 6 slices, then 13 Jacobi slices), one velocity
    iteration, with its wave table and its sums' order made once, as the main path makes
    them once per step. Returns (args, kw) of a ``contact_sweep`` call."""
    from bepuphysics2_tpu_torch.ops import sweep

    bank = sweep.synthetic_sweep_bank(336, 128, n_colored=sum(K3_COLORS), n_jacobi=13, seed=4,
                                      slices_per_color=list(K3_COLORS))
    args = sweep.sweep_bank_args(bank, dev)
    ps_t, idx2, sb = args[2], args[4], bank["sb"]
    order = sweep.writer_order(idx2.view(-1, 2 * sb), sweep.sweep_writes(ps_t, args[1], idx2, sb))
    return args, dict(sb=sb, n_iters=1, waves=torch.from_numpy(bank["waves"]).to(dev),
                      order=order)


def _k3_entries(args, sb):
    from bepuphysics2_tpu_torch.ops import sweep

    inertia7, ps_t, idx2 = args[1], args[2], args[4]
    live = (ps_t[sweep.PS_VALID].reshape(-1, sb) > 0.5).any(1)
    return [t.cpu() for t in (idx2.reshape(-1, 2 * sb).long(),
                              sweep.sweep_writes(ps_t, inertia7, idx2, sb),
                              sweep.row_valid(ps_t, sb), live)]


def _k3_steps(sim, steps):
    """Run ``steps`` steps of a K3 scene, recording every K3 call on the card and the
    inputs of every K3 wave table (``solver.solve.page_wave_table``), then hold each
    call's table to its contract and its order to ``writer_order``. Returns (calls,
    tables, checked)."""
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.solver import solve as tsolve

    calls, restore = _capture_calls("contact_sweep")
    tables = []
    fn = tsolve.page_wave_table
    tsolve.page_wave_table = lambda *a: tables.append(a) or fn(*a)
    try:
        sim.run(steps, DT)
    finally:
        tsolve.page_wave_table = fn
        restore()
    checked = []
    for a, k in calls:
        entries = _k3_entries(a, k["sb"])
        checked.append(_table_check("K3", k["waves"].cpu(), *entries))
        _require(torch.equal(k["order"].cpu(), sweep.writer_order(entries[0], entries[1])),
                 "K3's order does not list each slice's writing entries first")
    return calls, tables, checked


def _k3_structure_note(tables, num_colors):
    """The structure of one step's two K3 banks, from their wave tables' inputs."""
    parts = []
    for label, t in zip(("store", "compound bucket"), tables):
        per_color, jac = _k1_structure(*t)
        parts.append(f"{label} {t[1].shape[0] // t[2]} pages of {t[2]}: live pages per color "
                     f"{per_color}, {jac} Jacobi")
    return "; ".join(parts)


def _sweep_hold(label, kern, plain, args, kw, tol):
    """K3 or K4 (``kern``) against its plain version on one recorded call: finite,
    within ``tol``, bit-identical on a second run. Returns (max |diff|, the kernel's
    output)."""
    got = list(kern(*args, **kw))
    want = list(plain(*args, sb=kw["sb"], n_iters=kw["n_iters"]))
    _require(all(bool(torch.isfinite(t).all()) for t in got), f"{label}: a non-finite value")
    again = list(kern(*args, **kw))
    _require(all(torch.equal(g, a) for g, a in zip(got, again)),
             f"{label} is not deterministic run to run")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    _require(err <= tol, f"{label} disagrees with its plain version: {err} > {tol}")
    return err, got


def phase_kernel_k3(dev, tube_calls):
    """K3 against its plain version on phase 11's bank (``k3_bank``) and on the 32-ragdoll
    tube's own K3 calls of one step (``tube_calls``, recorded by phase 15 at the default
    settings, where every limb stays in the tube: both banks, 4 substeps; at bench.py's
    settings limbs fly at ~1e4 m/s, where no absolute limit holds). ``ms`` is the
    wrapper's call on the bank, ``kernel_ms`` its C entry point alone (``_bare_ms``)."""
    from bepuphysics2_tpu_torch.ops import sweep

    args, kw = k3_bank(dev)
    kern = lambda: sweep.contact_sweep(*args, **kw)
    plain = lambda: sweep._contact_sweep_plain(*args, sb=kw["sb"], n_iters=kw["n_iters"])
    err, plain_ms = _hold("K3", kern, plain, args[0], K3_TOL, outputs=list)
    ms = _time_ms(kern, 20)
    kernel_ms = _bare_ms("contact_sweep", kern, 20)
    v6, i7, ps_t, imp_t, idx2, scale = args[:6]
    live_rows = int((ps_t[sweep.PS_VALID] > 0.5).sum())
    live = _valid_slices(ps_t, 128)
    bound_ms, bound_by = _bound(
        _nbytes(v6, i7, imp_t, v6, imp_t) + _live_bytes(live, ps_t, idx2, scale),
        live_rows * _row_ops()["solve"])
    tube_err, moved, tube_ms, notes = 0.0, 0.0, 0.0, []
    for i, (a, k) in enumerate(tube_calls):
        e, got = _sweep_hold(f"K3 on the tube's call {i}", sweep.contact_sweep,
                             sweep._contact_sweep_plain, a, k, K3_TOL)
        tube_err, moved = max(tube_err, e), max(moved, float((got[0] - a[0]).abs().max()))
        tube_ms += _bare_ms("contact_sweep", lambda: sweep.contact_sweep(*a, **k), 20)
        if i < 2:
            notes.append(_shape_note("contact_sweep", k["sb"], k["waves"]))
    _require(moved > 1e-3, "K3 left the tube's velocities unchanged")
    print(f"[11 kernel] K3 vs plain at NB 336, B 7808 (61 slices of 128: 8 colors of 6, 13 "
          f"Jacobi), 1 iteration: max |diff| {err:.3e} (limit {K3_TOL}); {ms:.3f} ms through "
          f"the wrapper, the kernel alone {kernel_ms:.3f} ms; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}, {live_rows} live rows); "
          f"{_shape_note('contact_sweep', 128, kw['waves'])}; bit-identical repeat. "
          f"The tube's own {len(tube_calls)} K3 calls of one step (store, compound bucket per "
          f"substep): max |diff| {tube_err:.3e}, bit-identical repeats, the kernel alone "
          f"{tube_ms:.3f} ms per step; store: {notes[0]}; compound bucket: {notes[1]}")
    return dict(max_abs_err=max(err, tube_err), ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_main_path_tube(dev, name, smi, n_rag=32, warm=33, timed=96,
                         settle=max(31, int(6 * 4096 ** (1 / 3))), hold_frames=4):
    """The 32-ragdoll tube (bench.py's BENCH_RAGDOLLS sizing: 328 body slots, 321 bodies,
    576 joints) through bench.py's ragdoll sequence: build, 33 steps, 95 settle, autosize,
    33, ``timed`` timed (bench.py: 96). Every step must launch K3 eight times (two contact
    banks × 4 substeps × 1 iteration) and K1 and K2 never; the plain K3 must never run;
    the state must stay finite, with no overflow after autosize and no host sync in the
    timed window. Then,
    for ``hold_frames`` more frames carried on the CPU from the card's last state, every
    card step from the CPU's state must land within K3's limit of the CPU's step over the
    ragdolls wholly inside the tube. The limbs launched out of it are printed, not held:
    they fly at ~1e4 m/s up to ~1e7 m away, where one step turns a 1e-7 relative change
    of their velocities into a 1.5e-2 change of their angular velocities on the CPU alone
    (``tools/tube_sensitivity.py``), so no two f32 implementations agree there.

    Every ragdoll must stay whole (head-torso under 1.2, as ``tests/test_models.py``
    holds the JAX ragdoll). How many dynamic bodies end outside the tube is printed, not
    required: at bench.py's solver settings the first step spills the joints' Jacobi
    bucket (384 rows over a capacity of 176) and the next step launches limbs out of the
    tube, in the JAX package as in the port (``tools/reference_tube.py``). Phase 15 runs
    the tube at the package's default settings, where it stays inside."""
    from bepuphysics2_tpu_torch.ops import sweep

    sim = tube_sim(n_rag, dev)
    c = sim.config
    _require(n_rag != 32 or (c.body_capacity, sim.body_count, sim.constraint_count)
             == (336, 321, 576), "tube configuration drifted from bench.py's")
    plain_calls = []
    plain = sweep._contact_sweep_plain
    sweep._contact_sweep_plain = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    per_step = 2 * c.substeps * c.velocity_iterations
    stages = []
    try:
        sweep.solve_substeps_contacts.launches = 0
        sweep.solve_substeps_contacts_win.launches = 0
        sweep.contact_sweep.launches = 0
        t0 = time.perf_counter()
        sim.run(warm, DT)
        sim.run(settle, DT)
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        before = sweep.contact_sweep.launches
        sized = sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        probe = (sweep.contact_sweep.launches - before) // per_step
        sim.run(warm, DT)
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        sps, syncs = _timed_syncs(sim, timed)
        k3_calls, tables, checked = _k3_steps(sim, 2)
    finally:
        sweep._contact_sweep_plain = plain
    k1, k2, k3 = (sweep.solve_substeps_contacts.launches,
                  sweep.solve_substeps_contacts_win.launches, sweep.contact_sweep.launches)
    steps = warm + settle + probe + warm + timed + 2
    _require(len(k3_calls) == 2 * per_step and len(tables) == 2 * 2,
             f"{len(k3_calls)} K3 calls and {len(tables)} tables in 2 steps")
    diag = sim.last_diag
    st = sim.state
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy

    start = state_from_numpy(state_to_numpy(st), "cpu")
    n_held = int(_ragdolls_inside(start, n_rag).sum()) // 10
    held, held_all, _ = _card_steps_from_cpu(sim, dev, start, hold_frames,
                                             held=lambda s: _ragdolls_inside(s, n_rag))
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.ccache.penetration, *st.joint_impulses.values()]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "non-finite state")
    outside, n_dyn, min_y, reach, apart = _tube_shape(sim, n_rag)
    c = sim.config
    print(f"[12 main path] {n_rag}-ragdoll tube ({sim.body_count} bodies, "
          f"{sim.constraint_count} joints), {warm} + {settle} settle "
          f"+ autosize ({probe} probe steps, {sized['rounds']} rounds) + {warm} + {timed} "
          f"steps on {name} ({smi}): {sps:.2f} steps/s over the {timed} timed "
          f"steps; warm-up + settle {stages[0]:.1f} s, to the timed window {stages[1]:.1f} s; "
          f"pairs {int(diag.pair_count)}, contacts {int(diag.contact_count)}; {outside} of "
          f"{n_dyn} dynamic bodies outside the tube (min y {min_y:.3g}, max distance "
          f"from the axis {reach:.3g}), {int((apart >= 1.2).sum())} of {n_rag} ragdolls apart "
          f"(head-torso >= 1.2; max {apart.max():.3g}); "
          f"demand {[int(x) for x in diag.demand]}; autosized max_pairs {c.max_pairs}, "
          f"max_compound_pairs {c.max_compound_pairs}; K3 launches {k3} in {steps} steps, "
          f"K1 {k1}, K2 {k2}, plain K3 calls {len(plain_calls)}; host syncs per step {syncs:g}; "
          f"{hold_frames} more frames, each card step from the CPU's state within "
          f"{held:.3e} of the CPU's over the {n_held} ragdolls inside the tube (limit "
          f"{K3_TOL:g}, absolute and relative; {held_all:.3e} over every body, not held); "
          f"the last step's banks: {_k3_structure_note(tables[-2:], c.num_colors)}; K3 wave "
          f"tables of 2 steps after the timed window (store, compound bucket): "
          f"{_tables_note(checked[:2])}, each color wave's written bodies named by no other "
          f"row of the wave, sums in writer-first order")
    _require(n_held > 0, "no ragdoll is left inside the tube to hold")
    _require(held <= K3_TOL, "a card step of the tube disagrees with the CPU's beyond K3's limit")
    _require(k3 == per_step * steps and k1 == 0 and k2 == 0,
             "the tube did not solve through K3 alone, 8 launches per step")
    _require(not plain_calls, "the plain K3 ran on the card's main path")
    _require(not bool(diag.overflow), f"overflow after autosize (src {int(diag.overflow_src)})")
    _require(int(diag.contact_count) > 0, "no contacts in the tube")
    _require(apart.max() < 1.2, f"a ragdoll came apart (head-torso {apart.max()})")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    return k3


def phase_tube_default_settings(dev, name, smi, n_rag=32, warm=33, timed=96):
    """The 32-ragdoll tube at the package's default solver settings (color_cap_factor
    1.5, jacobi_cap_factor 0.3, color_rounds 3), where the first step's joint Jacobi
    bucket does not spill: 33 steps, then ``timed`` timed. Every dynamic body must stay inside
    the tube and every ragdoll whole, with no overflow over the timed steps, K3 launched 8
    times per step, no plain version and no host sync; two more steps hold their K3 wave
    tables to their contract. Returns the last step's K3 calls, which phase 11 holds K3
    on."""
    from bepuphysics2_tpu_torch.ops import sweep

    sim = tube_sim(n_rag, dev, bench=False)
    before = sweep.contact_sweep.launches
    calls, restore = _count_plain_calls()
    try:
        sim.run(warm, DT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sim.run(timed, DT)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
        _, syncs = _timed_syncs(sim, 4)
        k3_calls, tables, checked = _k3_steps(sim, 2)
    finally:
        restore()
    k3 = sweep.contact_sweep.launches - before
    diag = sim.last_diag
    outside, n_dyn, min_y, reach, apart = _tube_shape(sim, n_rag)
    print(f"[15 tube, default settings] {n_rag}-ragdoll tube, {warm} + {timed} steps on {name} "
          f"({smi}): {timed / elapsed:.2f} steps/s over the {timed} timed steps; pairs "
          f"{int(diag.pair_count)}, contacts {int(diag.contact_count)}; {outside} of {n_dyn} "
          f"dynamic bodies outside the tube (min y {min_y:.3g}, max distance from the axis "
          f"{reach:.3g}); max head-torso {apart.max():.3g}; demand "
          f"{[int(x) for x in diag.demand]}; K3 launches {k3} in {warm + timed + 6} steps, "
          f"plain calls {len(calls)}, host syncs per step {syncs:g}; the last step's banks: "
          f"{_k3_structure_note(tables[-2:], sim.config.num_colors)}; K3 wave tables of 2 more "
          f"steps (store, compound bucket): {_tables_note(checked[:2])}, each color wave's "
          f"written bodies named by no other row of the wave")
    _require(outside == 0, f"{outside} dynamic bodies left the tube")
    _require(apart.max() < 1.2, f"a ragdoll came apart (head-torso {apart.max()})")
    _require(not bool(diag.overflow), f"overflow in the timed steps (src {int(diag.overflow_src)})")
    _require(k3 == 8 * (warm + timed + 6) and len(k3_calls) == 16,
             "the tube did not launch K3 8 times per step")
    _require(not calls, f"a plain version ran on the card's main path: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the tube")
    return [_clone_call(a, k) for a, k in k3_calls[8:]]


def phase_determinism_tube(dev, steps=60):
    hashes = []
    for _ in range(2):
        sim = tube_sim(4, dev)
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    print(f"[13 determinism] 4-ragdoll tube, {steps} steps twice: state_hash {hashes[0]:#018x} "
          f"/ {hashes[1]:#018x}")
    _require(hashes[0] == hashes[1], "two identical tube runs on the card differ")


def phase_cpu_vs_card_tube(dev, tol=1e-4, frames=20):
    """The 2-ragdoll tube of the JAX package's model test (2 substeps, 4 colors), 20
    frames on the CPU. Each frame, stepped again on the card from the CPU's state before
    it, must land on the CPU's next state within ``tol`` (absolute and relative: K3's
    limit against its plain version). Both 20-frame trajectories are printed beside it,
    not held to the pile's envelope: this scene is chaotic from frame 3 (a difference of
    5e-7 grows to 5e-2 in one frame, between the JAX package's own two paths alike)."""
    card = tube_sim(2, dev, substeps=2, num_colors=4)
    worst, last = _card_steps_from_states(card, _cpu_result("14"))
    card.run(frames, DT)
    traj = np.abs(np.stack(list(last.bodies.pos)) - positions(card))
    print(f"[14 cpu vs card] 2-ragdoll tube, {frames} frames: each card step from the CPU's "
          f"state within {worst:.3e} of the CPU's (limit {tol:g}, absolute and relative); "
          f"the two trajectories after {frames} frames: max |dpos| {traj.max():.3e}, median "
          f"{np.median(traj):.3e} (chaotic scene, not held)")
    _require(worst <= tol, "a card step disagrees with the CPU's beyond K3's limit")
    _require(np.isfinite(positions(card)).all(), "non-finite card trajectory")


# --- slice 4: the ragdoll pile above 8,192 bodies (K4) and the compound pile (K1) ---------

PILE_RAGDOLLS = 1024  # 10,240 dynamic bodies, 9,216 ball sockets, 9,216 swing limits


def _heads_apart(state, n_rag):
    """Head-torso distance of every ragdoll of a pile (ground at slot 0; ragdoll r holds
    bodies 1 + 10r to 10 + 10r, torso first, head second)."""
    pos = np.stack([t.cpu().numpy() for t in state.bodies.pos])
    torso, head = 1 + 10 * np.arange(n_rag), 2 + 10 * np.arange(n_rag)
    return np.linalg.norm(pos[:, head] - pos[:, torso], axis=0)


def _padded_bank(config, n_bodies):
    """Rows of the windowed store bank (``windowing.row_windows``' bp) for a config: the
    store, one partial slice per (color, Morton block) group, the wide region."""
    cap, _ = config.store_layout()
    nblk = -(-n_bodies // 1024)
    wide_cap = max(256, -(-(config.wide_cap_rows or cap // 8) // 256) * 256)
    return cap + (config.num_colors + 1) * nblk * 256 + wide_cap


def phase_kernel_k4(dev, n_rows):
    """K4 against its plain version on phase 16's bank (``k4_bank``): the ragdoll pile's
    shapes with ``n_rows`` store rows (the capacity autosize gives the pile)."""
    from bepuphysics2_tpu_torch.ops import sweep

    t0 = time.perf_counter()
    bank, args, kw = k4_bank(n_rows, dev)
    made = time.perf_counter() - t0
    waves = torch.from_numpy(bank["waves"]).to(dev)
    v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg = args[:8]
    # The sums' order, made once as the main path makes it once per step.
    order = sweep.writer_order(sweep.window_positions(whi2, wlo2, wseg, kw["sb"]),
                               sweep.stream_writes(ps_t, it_t, kw["sb"]))
    kern = lambda: sweep.contact_sweep_win(*args, **kw, waves=waves, order=order)
    plain = lambda: sweep._contact_sweep_win_plain(*args, **kw)
    err, plain_ms = _hold("K4", kern, plain, args[0], K4_TOL, outputs=list)
    ms = _time_ms(kern, 20)
    kernel_ms = _bare_ms("contact_sweep_win", kern, 20)
    live_rows = int((ps_t[sweep.PS_VALID] > 0.5).sum())
    bound_ms, bound_by = _bound(
        _nbytes(v6p, imp_t, wseg, v6p, imp_t)
        + _live_bytes(wseg[:, 0] >= 0, it_t, ps_t, whi2, wlo2, scale),
        live_rows * _row_ops()["solve"])
    print(f"[16 kernel] K4 vs plain at NP {v6p.shape[0]}, BP {bank['bp']} ({n_rows} store rows; "
          f"{bank['live_slices']} live slices of 256, {bank['wide_rows']} wide rows, "
          f"{live_rows} live rows), 1 iteration: max |diff| {err:.3e} (limit {K4_TOL}); "
          f"{ms:.3f} ms through the wrapper, the kernel alone {kernel_ms:.3f} ms; plain "
          f"{plain_ms:.1f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}); {_shape_note('contact_sweep_win', 256, waves)}; "
          f"bit-identical repeat; bank built in {made:.1f} s")
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _count_plain_calls():
    """Wrap every kernel's plain version with a call counter. Returns (calls, restore)."""
    from bepuphysics2_tpu_torch.collision import sweeps
    from bepuphysics2_tpu_torch.ops import sweep

    names = [(sweep, n) for n in ("_solve_substeps_contacts_plain",
                                  "_solve_substeps_contacts_win_plain", "_contact_sweep_plain",
                                  "_contact_sweep_win_plain")] + [(sweeps, "_advance")]
    saved = {(m, n): getattr(m, n) for m, n in names}
    calls = []

    def counted(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    for (m, n), fn in saved.items():
        setattr(m, n, counted(n, fn))
    return calls, lambda: [setattr(m, n, fn) for (m, n), fn in saved.items()]


def _kernel_launches():
    from bepuphysics2_tpu_torch.ops import sweep

    return dict(K1=sweep.solve_substeps_contacts.launches,
                K2=sweep.solve_substeps_contacts_win.launches,
                K3=sweep.contact_sweep.launches, K4=sweep.contact_sweep_win.launches)


def _zero_launches():
    from bepuphysics2_tpu_torch.ops import sweep

    for fn in (sweep.solve_substeps_contacts, sweep.solve_substeps_contacts_win,
               sweep.contact_sweep, sweep.contact_sweep_win):
        fn.launches = 0


def phase_main_path_pile(dev, name, smi, warm=33, timed=32,
                         settle=max(31, int(6 * 4096 ** (1 / 3)))):
    """The 1,024-ragdoll pile (10,240 dynamic bodies, 18,432 joints, 16 colors, 4
    substeps, 1 iteration, sleep on) through bench.py's ragdoll sequence: build, ``warm``
    steps, ``settle`` steps (the top layer lands at about step 72: autosize must measure
    the pile after it), autosize, ``warm`` steps, ``timed`` timed steps. Above 8,192 body
    slots it runs grid2 and the windowed layout, and every step must launch K4 substeps x
    iterations = 4 times, K1, K2 and K3 never, and no plain version; the state must stay
    finite with no overflow after autosize, every body above y = -0.2, every ragdoll
    whole, and no host sync in the timed window. The overflow bits of the steps before
    autosize are printed. Returns (K4 launches, the autosized max_pairs)."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.simulation import D_ENTRIES, D_WIDE

    t0 = time.perf_counter()
    sim, c = build_ragdoll_pile_sim(PILE_RAGDOLLS, device=dev)
    built = time.perf_counter() - t0
    _require((c.body_capacity, sim.body_count, sim.constraint_count, c.num_colors)
             == (10256, 10241, 18432, 16), "ragdoll pile configuration drifted")
    per_step = c.substeps * c.velocity_iterations
    calls, restore = _count_plain_calls()
    stages = []
    try:
        _zero_launches()
        t0 = time.perf_counter()
        sim.run(warm + settle, DT)
        early_src = int(sim.last_diag.overflow_src)
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        early = _kernel_launches()["K4"]
        _require(early == per_step * (warm + settle),
                 f"K4 launched {early} times in the {warm + settle} steps before autosize")
        sized = sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        probe, rest = divmod(_kernel_launches()["K4"] - early, per_step)
        _require(rest == 0 and probe >= 32 and probe % 32 == 0,
                 f"autosize ran {probe} steps and {rest} launches off K4")
        sim.run(warm - 2, DT)
        k4_calls, restore_k4 = _capture_calls("contact_sweep_win")
        try:
            sim.run(2, DT)  # their K4 calls' tables are held to their contract below
        finally:
            restore_k4()
        torch.cuda.synchronize()
        stages.append(time.perf_counter() - t0)
        st = sim.state.bodies
        dyn = st.kind == KIND_DYNAMIC
        awake = float((st.awake & dyn).sum()) / float(dyn.sum())
        sps, syncs = _timed_syncs(sim, timed)
    finally:
        restore()
    launches = _kernel_launches()
    steps = warm + settle + probe + warm + timed
    _require(len(k4_calls) == 2 * per_step, f"{len(k4_calls)} K4 calls in 2 steps")
    checked = []
    for a, k in k4_calls:
        entries = _k4_entries(a, k["sb"])
        checked.append(_table_check("K4", k["waves"].cpu(), *entries))
        _require(torch.equal(k["order"].cpu(), sweep.writer_order(entries[0], entries[1])),
                 "K4's order does not list each slice's writing entries first")
    diag = sim.last_diag
    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw,
              *st.joint_impulses.values()]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "non-finite state")
    dyn = st.bodies.kind == KIND_DYNAMIC
    min_y = float(st.bodies.pos.y[dyn].min())
    apart = _heads_apart(st, PILE_RAGDOLLS)
    demand = [int(x) for x in diag.demand]
    pairs, contacts = int(diag.pair_count), int(diag.contact_count)
    c = sim.config
    print(f"[17 main path] {PILE_RAGDOLLS}-ragdoll pile ({sim.body_count} bodies, "
          f"{sim.constraint_count} joints, {c.num_colors} colors), built in {built:.1f} s, "
          f"{warm} + {settle} settle + autosize ({probe} probe steps, {sized['rounds']} "
          f"rounds) + {warm} + {timed} steps on {name} ({smi}): {sps:.3f} steps/s "
          f"over the {timed} timed steps ({awake:.3f} of the dynamic bodies awake at their "
          f"start); warm-up + settle {stages[0]:.1f} s (overflow bits {early_src}), to the "
          f"timed window {stages[1]:.1f} s; pairs {pairs}, "
          f"contacts {contacts}, wide-row demand {demand[D_WIDE]}, padded bank "
          f"{_padded_bank(c, c.body_capacity)} rows, grid entries {demand[D_ENTRIES]}, min "
          f"dynamic y {min_y:.3f}, max head-torso {apart.max():.3f}; demand {demand}; "
          f"autosized max_pairs {c.max_pairs}, wide_cap_rows {c.wide_cap_rows}; launches "
          f"{launches} in {steps} steps, plain calls {len(calls)}; host syncs per step {syncs:g}"
          f"; K4 wave tables of the 2 steps before the timed window (per step): "
          f"{_tables_note(checked[::per_step])}, each color wave's written bodies named by no "
          f"other row of the wave, sums in writer-first order")
    _require(demand[D_ENTRIES] > 0, "the grid2 broad phase did not run")
    _require(launches == dict(K1=0, K2=0, K3=0, K4=per_step * steps),
             f"the pile did not solve through K4 alone, {per_step} launches per step")
    _require(not calls, f"a plain version ran on the card's main path: {sorted(set(calls))}")
    _require(not bool(diag.overflow), f"overflow after autosize (src {int(diag.overflow_src)})")
    _require(min_y > -0.2, f"a dynamic body fell through the ground (y = {min_y})")
    _require(pairs > 0 and contacts > 0, "no pairs or no contacts in the pile")
    _require(apart.max() < 1.2, f"a ragdoll came apart (head-torso {apart.max()})")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    return launches["K4"], c.max_pairs


def _small_ragdoll_pile(device, n_rag=8):
    from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim

    sim, _ = build_ragdoll_pile_sim(n_rag, device=device, solver_backend="pallas_win",
                                    broadphase="grid2")
    return sim


def phase_determinism_pile(dev, steps=30):
    hashes = []
    for _ in range(2):
        sim = _small_ragdoll_pile(dev)
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    print(f"[18 determinism] 8-ragdoll pile on the windowed general path (grid2, K4), {steps} "
          f"steps twice: state_hash {hashes[0]:#018x} / {hashes[1]:#018x}")
    _require(hashes[0] == hashes[1], "two identical pile runs on the card differ")


def phase_cpu_vs_card_pile(dev, tol=1e-4, frames=10):
    """The 8-ragdoll pile of phase 18, 10 frames on the CPU (K4's plain version). Each
    frame, stepped again on the card from the CPU's state before it, must land on the
    CPU's next state within ``tol`` (absolute and relative: K4's limit against its plain
    version). Limbs colliding at their joint anchors make the trajectories chaotic, so
    steps are held, not trajectories."""
    card = _small_ragdoll_pile(dev)
    before = _kernel_launches()["K4"]
    worst, last = _card_steps_from_states(card, _cpu_result("19"))
    k4 = _kernel_launches()["K4"] - before
    pos = np.stack(list(last.bodies.pos))
    print(f"[19 cpu vs card] 8-ragdoll pile, {frames} frames: each card step from the CPU's "
          f"state within {worst:.3e} of the CPU's (limit {tol:g}, absolute and relative); "
          f"K4 launches {k4}; CPU min y {pos[1][1:81].min():.3f}")
    _require(worst <= tol, "a card step of the pile disagrees with the CPU's beyond K4's limit")
    _require(k4 == 4 * frames, "the card steps did not launch K4 4 times each")


def phase_compound_pile(dev, n_bodies=252, frames=10):
    """The contact-only compound pile (``build_compound_pile_sim``: 252 spheres and boxes
    in the ragdoll tube's spinning tube, no joints): ``frames`` frames on the CPU, each
    stepped again on the card from the CPU's state before it within K1's 1e-4 (absolute
    and relative) of the CPU's; on the card K1 launches once per step and K2, K3 and K4
    never; finite, no overflow. The card's own run of the scene holds its last two steps'
    K1 wave tables to their contract, with no wave across the two banks, and makes no
    host sync."""
    from bepuphysics2_tpu_torch.models import build_compound_pile_sim
    from bepuphysics2_tpu_torch.ops import sweep

    card, _ = build_compound_pile_sim(n_bodies, device=dev)
    before = _kernel_launches()
    worst, _ = _card_steps_from_states(card, _cpu_result("20"))
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    k1_before = _kernel_launches()["K1"]
    card.run(frames - 2, DT)
    k1_calls, tables = _k1_steps(card, 2)
    _require(len(k1_calls) == 2 and _kernel_launches()["K1"] - k1_before == frames,
             "the compound pile's card run did not launch K1 once per step")
    n_store = card.state.store.page_color.shape[0]
    checked = []
    for (a, k), t in zip(k1_calls, tables):
        checked.append(_table_check("K1", k["waves"].cpu(), *_k1_entries(a, k["sb"])))
        _require(len(t[0]) == 2, "the compound pile's K1 stream is not the store and one bucket")
        _require(all(w[0] >= n_store or w[-1] < n_store
                     for w in sweep.wave_lists(k["waves"])), "a K1 wave spans two banks")
    _, syncs = _timed_syncs(card, 4)
    diag = card.last_diag
    st = card.state
    leaves = [*st.bodies.pos, *st.bodies.vel, st.ccache.penetration, st.store.imp_pen]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "non-finite state")
    print(f"[20 compound pile] {n_bodies} bodies in the tube, {frames} frames: each card step "
          f"from the CPU's state within {worst:.3e} of the CPU's (limit {K1_TOL:g}); launches "
          f"over those steps {launches}; card run: contacts {int(diag.contact_count)}, "
          f"overflow {bool(diag.overflow)}, K1 wave tables of its last 2 steps: "
          f"{_tables_note(checked)}, no wave across the store's {n_store} pages and the "
          f"bucket; host syncs per step {syncs:g}")
    _require(syncs == 0, f"{syncs} host syncs per step on the compound pile")
    _require(worst <= K1_TOL, "a card step of the compound pile disagrees with the CPU's")
    _require(launches == dict(K1=frames, K2=0, K3=0, K4=0),
             "the compound pile did not solve through one K1 launch per step")
    _require(not bool(diag.overflow), f"overflow (src {int(diag.overflow_src)})")
    _require(int(diag.contact_count) > 0, "no contacts in the compound pile")


# --- slice 9: iteration schedules and velocity callbacks (K3, K4) ---------------------------

SCHEDULE = (2, 1, 1, 1)  # velocity iterations per substep (SolveConfig.iteration_schedule)
# Phase 24's capacities, sized up front for the settled 16k pile (its peak demand: ~97k
# pairs, ~32k wide rows, cell windows over 16 and rows over 8 candidates), as the ragdoll
# pile's builder sizes for its landing: at bench.py's capacities the pile overflows the
# broad phase's cell windows, the store's pages and the wide rows before autosize, and
# the substep loop's bucket, which orders rows by page execution, drops other rows than
# K2's slot-order pack: three bodies fell through the ground (ROADMAP queue 3).
SCHEDULE_16K_CAPS = dict(max_pairs=196608, wide_cap_rows=65536, grid_cell_capacity=64,
                         grid_pair_k=32)
RADIAL_CENTRE = (0.0, -1000.5, 0.0)  # 1,000 m below the ground box's centre


def radial_gravity(state, dt):
    """Phase 23's velocity callback (``IntegratorConfig.velocity_callback``): gravity of
    magnitude 10 toward ``RADIAL_CENTRE`` and a linear damping of 0.05/s, computed from
    the state on its device, no host sync."""
    from bepuphysics2_tpu_torch.utils.vec import Vec3

    rx, ry, rz = (RADIAL_CENTRE[0] - state.pos.x, RADIAL_CENTRE[1] - state.pos.y,
                  RADIAL_CENTRE[2] - state.pos.z)
    k = 10.0 / torch.sqrt(rx * rx + ry * ry + rz * rz)
    return (state.vel + Vec3(rx * k, ry * k, rz * k) * dt) * (1.0 - 0.05) ** dt, state.omega


def _schedule_overrides(callback=True):
    from bepuphysics2_tpu_torch.integrator import IntegratorConfig

    out = dict(iteration_schedule=SCHEDULE)
    if callback:
        out["integrator"] = IntegratorConfig(velocity_callback=radial_gravity)
    return out


def phase_schedule_pile(dev, name, smi, warm=33, timed=32, settle=64):
    """The 4,096-body pile of phase 4 (bench.py's settings) with the iteration schedule
    (2, 1, 1, 1) and the radial-gravity callback: off K1, through the general path's
    substep loop, its store a K3 bank of 512-row pages whose color waves hold several
    pages. Every step launches K3 once per substep (the store is the lone contact bank:
    as in the JAX package, one kernel call per substep carries that substep's
    iterations, 5 in all), K1, K2 and K4 never, no plain version, no host sync. After
    ``warm`` steps, ``timed`` steps are timed; after ``settle`` more (phase 4's 129 in all,
    when the store holds its settled pages) two steps' K3 wave tables are held to their
    contract and K3 is held against its plain version on the scene's own last K3 call.
    Returns the K3 launches."""
    from bepuphysics2_tpu_torch.ops import sweep

    sim = build_pile(4096, dev, **_schedule_overrides())
    c = sim.config
    _require((c.body_capacity, c.max_pairs, c.substeps) == (4160, 32768, len(SCHEDULE)),
             "pile configuration drifted from bench.py's")
    calls, restore = _count_plain_calls()
    try:
        _zero_launches()
        sim.run(warm, DT)
        sps, syncs = _timed_syncs(sim, timed)
        sim.run(settle, DT)
        k3_calls, tables, checked = _k3_steps(sim, 2)
    finally:
        restore()
    launches = _kernel_launches()
    steps = warm + timed + settle + 2
    min_y, pairs, contacts = _pile_gates(sim, "the scheduled 4k pile")
    per_step = len(SCHEDULE)
    iters = [k["n_iters"] for _, k in k3_calls]
    _require(launches == dict(K1=0, K2=0, K3=per_step * steps, K4=0),
             f"the pile did not solve through K3 alone, {per_step} launches per step: {launches}")
    _require(iters == list(SCHEDULE) * 2, f"K3's iterations per call {iters}, not the schedule's")
    _require(len(tables) == 2, f"{len(tables)} K3 wave tables in 2 steps")
    _require(not calls, f"a plain version ran on the card's main path: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    per_color, jac = _k1_structure(*tables[-1])
    a, k = _clone_call(*k3_calls[-1])
    err, got = _sweep_hold("K3 on the scheduled pile's last call", sweep.contact_sweep,
                           sweep._contact_sweep_plain, a, k, K3_TOL)
    _require(float((got[0] - a[0]).abs().max()) > 1e-4, "K3 left the pile's velocities unchanged")
    kernel_ms = _bare_ms("contact_sweep", lambda: sweep.contact_sweep(*a, **k), 20)
    note = (f"the pile's last K3 call ({k['n_iters']} iteration, "
            f"{a[2].shape[1] // k['sb']} pages of {k['sb']}): max |diff| {err:.3e}, the kernel "
            f"alone {kernel_ms:.3f} ms; {_shape_note('contact_sweep', k['sb'], k['waves'])}")
    print(f"[23 schedule pile] 4096-body pile, schedule {SCHEDULE}, radial gravity toward "
          f"{RADIAL_CENTRE} with damping 0.05/s, {warm} + {timed} + {settle} + 2 steps on "
          f"{name} ({smi}): "
          f"{sps:.2f} steps/s over the {timed} timed steps; pairs {pairs}, contacts "
          f"{contacts}, min dynamic y {min_y:.3f}; launches {launches} in {steps} steps "
          f"({per_step} K3 per step carrying {sum(SCHEDULE)} iterations: {iters[:per_step]}), "
          f"plain calls {len(calls)}, host syncs per step {syncs:g}; the last step's store: "
          f"{a[2].shape[1] // k['sb']} pages of {k['sb']}, live pages per color {per_color}, "
          f"{jac} Jacobi; K3 wave tables of 2 steps: {_tables_note(checked[::per_step])}, "
          f"each color wave's written bodies named by no other row of the wave, sums in "
          f"writer-first order; K3 vs plain on {note} (limit {K3_TOL:g}), bit-identical repeat")
    return launches["K3"]


def phase_schedule_pile_win(dev, name, smi, warm=33, timed=32,
                            settle=max(31, int(6 * 16384 ** (1 / 3)))):
    """The 16,384-body pile of phase 8 with the iteration schedule (2, 1, 1, 1) and
    ``SCHEDULE_16K_CAPS``: grid2, bench.py's sequence with autosize (``warm`` steps, the
    settle, autosize, ``warm``, ``timed`` timed), off K2, through the substep loop's
    windowed store bucket: K4 once per iteration (5 per step), K1, K2 and K3 never, no
    plain version, no host sync, no overflow bit before autosize; the pile's gates after
    it; two steps' K4 wave tables held to their contract and K4 held against its plain
    version on the scene's own last K4 call. Returns the K4 launches."""
    from bepuphysics2_tpu_torch.ops import sweep
    from bepuphysics2_tpu_torch.simulation import D_ENTRIES

    n = 16384
    sim = build_pile(n, dev, **_schedule_overrides(callback=False), **SCHEDULE_16K_CAPS)
    per_step = sum(SCHEDULE)
    calls, restore = _count_plain_calls()
    try:
        _zero_launches()
        t0 = time.perf_counter()
        sim.run(warm + settle, DT)
        early_src = int(sim.last_diag.overflow_src)
        _require(early_src == 0, f"overflow before autosize (src {early_src})")
        before = _kernel_launches()["K4"]
        sized = sim.autosize(DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        probe, rest = divmod(_kernel_launches()["K4"] - before, per_step)
        _require(rest == 0 and probe >= 32 and probe % 32 == 0,
                 f"autosize ran {probe} steps and {rest} launches off K4")
        sim.run(warm - 2, DT)
        k4_calls, restore_k4 = _capture_calls("contact_sweep_win")
        try:
            sim.run(2, DT)
        finally:
            restore_k4()
        torch.cuda.synchronize()
        to_window = time.perf_counter() - t0
        sps, syncs = _timed_syncs(sim, timed)
    finally:
        restore()
    launches = _kernel_launches()
    steps = warm + settle + probe + warm + timed
    min_y, pairs, contacts = _pile_gates(sim, "the scheduled 16k pile after autosize")
    demand = [int(x) for x in sim.last_diag.demand]
    _require(demand[D_ENTRIES] > 0, "the grid2 broad phase did not run")
    _require(launches == dict(K1=0, K2=0, K3=0, K4=per_step * steps),
             f"the pile did not solve through K4 alone, {per_step} launches per step: {launches}")
    _require(len(k4_calls) == 2 * per_step, f"{len(k4_calls)} K4 calls in 2 steps")
    _require(not calls, f"a plain version ran on the card's main path: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    checked = []
    for a, k in k4_calls[::per_step]:
        entries = _k4_entries(a, k["sb"])
        checked.append(_table_check("K4", k["waves"].cpu(), *entries))
        _require(torch.equal(k["order"].cpu(), sweep.writer_order(entries[0], entries[1])),
                 "K4's order does not list each slice's writing entries first")
    a, k = _clone_call(*k4_calls[-1])
    err, _ = _sweep_hold("K4 on the scheduled 16k pile's last call", sweep.contact_sweep_win,
                         sweep._contact_sweep_win_plain, a, k, K4_TOL)
    c = sim.config
    print(f"[24 schedule pile, windowed] {n}-body pile, schedule {SCHEDULE}, capacities "
          f"{SCHEDULE_16K_CAPS} (no overflow bit before autosize), {warm} + {settle} "
          f"settle + autosize ({probe} probe steps, {sized['rounds']} rounds) + {warm} + "
          f"{timed} steps on {name} ({smi}): {sps:.2f} steps/s over the {timed} timed steps; "
          f"to the timed window {to_window:.1f} s; pairs {pairs}, contacts {contacts}, min "
          f"dynamic y {min_y:.3f}; demand {demand}; autosized max_pairs {c.max_pairs}, "
          f"wide_cap_rows {c.wide_cap_rows}; launches {launches} in {steps} steps "
          f"({per_step} K4 per step, one per iteration), plain calls {len(calls)}, host syncs "
          f"per step {syncs:g}; K4 wave tables of 2 steps: {_tables_note(checked)}, each color "
          f"wave's written bodies named by no other row of the wave, sums in writer-first "
          f"order; K4 vs plain on the last K4 call: max |diff| {err:.3e} (limit {K4_TOL:g}), "
          f"bit-identical repeat")
    return launches["K4"]


# --- slice 5: the TPU design probes of experiments/ (K5, K6, K7) ----------------------------

def _host_ms(fn):
    """Milliseconds of one call of ``fn`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_probe_sweep(dev):
    """The sweep prototypes' main (``experiments.sweep_proto``) on the card, K5's count
    zeroed before it: every variant (v1, v2 A-D and v3 share one launch shape, v4 has
    its own) within 1e-5 of its plain version on the card, then bit-identical on a
    repeat; the state moved (mode C: within 1e-6 of its input, 1e-30 of a sum being below
    f32 resolution); and v1 on passes that repeat bodies. Times: main's per call (with
    the wrapper's stable sort) and the kernel's alone (sort made beforehand)."""
    from bepuphysics2_tpu_torch.experiments import sweep_proto
    from bepuphysics2_tpu_torch.ops import probes

    probes.probe_sweep.launches = 0
    rows = sweep_proto.main(dev)
    launches = probes.probe_sweep.launches
    _require(launches == 52 * len(rows), f"K5 launched {launches} times in the probes' main")
    v6d, idxd = sweep_proto.inputs_with_duplicates()
    _, fn, lanes, transposed, mode = sweep_proto.VARIANTS[0]
    state = probes.to_state(torch.from_numpy(v6d), lanes, transposed).to(dev)
    idx = torch.from_numpy(idxd).to(dev)
    dup = dict(name="v1 repeated bodies", fn=fn, lanes=lanes, transposed=transposed,
               mode=mode, state=state, idx=idx, out=fn(state, idx))
    dup["want"] = probes._probe_sweep_plain(state, idx, lanes, transposed, mode)
    dup["max_abs_err"] = float((dup["out"] - dup["want"]).abs().max())
    for r in [*rows, dup]:
        err, out, state = r["max_abs_err"], r["out"], r["state"]
        _require(bool(torch.isfinite(out).all()), f"K5 {r['name']}: a non-finite value")
        _require(err <= K5_TOL, f"K5 {r['name']} disagrees with its plain version: {err}")
        _require(torch.equal(r["fn"](state, r["idx"]), out), f"K5 {r['name']} is not "
                 "deterministic run to run")
        moved = float((out - state).abs().max())
        _require(moved <= 1e-6 if r["mode"] == "C" else moved > 1e-1,
                 f"K5 {r['name']}: the state moved by {moved}")
    passes = rows[0]["idx"].shape[0]
    for r in rows:
        order = probes._stable_order(r["idx"])
        distinct = probes.distinct_passes(r["idx"], order)
        r["kernel_ms"] = _time_ms(lambda: probes.probe_sweep(
            r["state"], r["idx"], lanes=r["lanes"], transposed=r["transposed"],
            mode=r["mode"], order=order, distinct=distinct), 50)
    parts = [f"{r['name']} {r['max_abs_err']:.2e}, {r['ms']:.4f} ms ({r['us_per_pass']:.3f} "
             f"us/pass), kernel {r['kernel_ms']:.4f} ms ({r['kernel_ms'] * 1e3 / passes:.3f} "
             f"us/pass)" for r in rows] + [f"{dup['name']} {dup['max_abs_err']:.2e}"]
    v1 = rows[0]
    split = k5_breakdown(k5_parts(v1["idx"]), v1["state"])
    m = v1["idx"].shape[1]
    nb = v1["state"].numel() // 8
    per_row = _ops_per_item(probes._sweep_pass_plain, torch.zeros(nb, 8),
                            torch.tensor([5]), 128, "B")
    bound_ms, bound_by = _bound(_nbytes(v1["state"], v1["idx"], v1["out"]),
                                per_row * m * passes)
    print(f"[21 probe sweep] K5 through sweep_proto.main: NB {nb}, M {m}, {passes} passes; "
          f"launches {launches}; max |diff| vs plain (limit {K5_TOL:g}), ms per call over 50 "
          f"calls: {'; '.join(parts)}; v1 plain {v1['plain_ms']:.2f} ms; bound "
          f"{bound_ms:.6f} ms ({bound_by}; {per_row} ops per row); bit-identical repeats; v1's "
          f"pass split, the kernel alone in turns: {_split_note(split, passes)}")
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in [*rows, dup]),
                ms=v1["kernel_ms"], plain_ms=v1["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def k5_c_args(state, idx, kw, flags=True, passes=None):
    """K5's C arguments as its wrapper makes them (``flags``: with the distinct flags, as
    the current entry point takes them), with ``passes`` in place of idx's when given, for
    ``kw``'s layout and mode. Returns (args, the tensors they point to)."""
    from bepuphysics2_tpu_torch.ops import build, probes

    out = torch.empty_like(state)
    order = probes._stable_order(idx)
    distinct = probes.distinct_passes(idx, order)
    args = (state.data_ptr(), out.data_ptr(), idx.data_ptr(), order.data_ptr(),
            *([distinct.data_ptr()] if flags else []), state.numel() // 8, idx.shape[1],
            idx.shape[0] if passes is None else passes, kw["lanes"], int(kw["transposed"]),
            probes.MODES[kw["mode"]], build.raw_stream(state.device))
    return args, (out, order, distinct)


def k5_parts(idx):
    """The current K5's runs for ``k5_breakdown``: an empty pass list, passes that only
    load their indices, passes without the math, passes without the scatter (the
    ``K5_PARTS`` variants, built in phase 2), and the whole kernel."""
    from bepuphysics2_tpu_torch.ops import build, probes

    full = build.bind("probe_sweep", "probe_sweep_launch", probes._SWEEP_ARGS)
    runs = {"empty pass list": (full, True, 0, idx)}
    for label, k in K5_PARTS:
        runs[label] = (build.bind("probe_sweep", "probe_sweep_launch", probes._SWEEP_ARGS,
                                  defines=(f"K5_PARTS={k}",)), True, None, idx)
    runs["whole"] = (full, True, None, idx)
    return runs


def k5_breakdown(runs, state, reps=50, rounds=2):
    """Each of ``runs`` ({label: (C entry point, takes the distinct flags, passes or None
    for all, indices)}) on v1's state, the entry point alone (CUDA events, ``reps`` calls
    each, ``rounds`` times in turns). Returns {label: mean ms}."""
    kw = dict(lanes=128, transposed=False, mode="B")
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, (fn, flags, passes, idx) in runs.items():
            args, keep = k5_c_args(state, idx, kw, flags, passes)
            _require(fn(*args) == 0, f"K5 ({label}) failed to launch")
            times[label].append(_time_ms(lambda: fn(*args), reps))
    return {label: float(np.mean(t)) for label, t in times.items()}


def _split_note(split, passes):
    """``k5_breakdown``'s times as each run's microseconds per pass over the empty list's."""
    base = split["empty pass list"]
    per = lambda label: (split[label] - base) * 1e3 / passes
    rest = [label for label in split if label != "empty pass list"]
    return (f"empty pass list {base:.4f} ms; per pass: "
            + ", ".join(f"{label} {per(label):.3f} us" for label in rest))


def phase_probe_gather_scatter(dev):
    """The gather probe's main (``experiments.gather_probe``) on the card, K6's and K7's
    counts zeroed before it: k1-k4 and k6 through K6 and k5 through K7, each exactly its
    plain version (a gather and a last-writer copy are exact) and again on a repeat; k5
    also bit for bit on ``gather_probe.scatter_cases`` (distinct ``d`` rows, where the
    last writer shows, and K7's edge cases). K6's library call is ``torch.index_select``,
    timed in turns with K6 through its wrapper; K6's bare C call and an empty ctypes call
    of its arguments show what the wrapper's floor is. K7 is timed on main's own call
    through its wrapper, as its bare C call and as its grid of an empty kernel (the launch
    floor); it has no library call (no one PyTorch call keeps the last writer)."""
    from bepuphysics2_tpu_torch.experiments import gather_probe
    from bepuphysics2_tpu_torch.ops import probes

    probes.probe_gather.launches = probes.probe_scatter.launches = 0
    rows = gather_probe.main(dev)
    k6, k7 = probes.probe_gather.launches, probes.probe_scatter.launches
    _require((k6, k7) == (52 * 5, 52), f"K6 and K7 launched {k6} and {k7} times in the main")
    v, idx, d = next(r for r in rows if r["kernel"] == "K7")["args"]
    bits = lambda t: t.view(torch.int32)
    cases = []
    for label, *args in gather_probe.scatter_cases(dev):
        out = gather_probe.k5(*args)
        same = torch.equal(bits(out), bits(probes._probe_scatter_plain(*args)))
        cases.append(dict(label=f"k5 {label}", fn=gather_probe.k5, args=tuple(args), out=out,
                          max_abs_err=0.0 if same else float("inf")))
    for r in [*rows, *cases]:
        _require(r["max_abs_err"] == 0.0, f"{r['label']} differs from its plain version")
        _require(torch.equal(bits(r["fn"](*r["args"])), bits(r["out"])), f"{r['label']} is "
                 "not deterministic run to run")
    nb, w = v.shape
    m, uniq = idx.numel(), int(torch.unique(idx).numel())
    gather = rows[0]
    g_bound = _bound(uniq * w * 4 + _nbytes(idx, gather["out"]), 0)  # distinct rows read
    # K7 on gather_probe.main's own call (one launch, no sort ahead of it): through its
    # wrapper, its bare C entry point, and the same grid of an empty kernel through the
    # same binding (the launch floor under it).
    from bepuphysics2_tpu_torch.ops import build

    s_ms = _time_ms(lambda: probes.probe_scatter(v, idx, d), 200)
    s_out = torch.empty_like(v)
    s_args = (v.data_ptr(), idx.data_ptr(), d.data_ptr(), s_out.data_ptr(), nb, m, w,
              build.raw_stream(dev))
    s_bare_fn = build.bind("probe_scatter", "probe_scatter_launch", probes._SCATTER_ARGS)
    s_empty_fn = build.bind("probe_scatter", "probe_scatter_empty_launch", probes._SCATTER_ARGS)
    s_bare = _time_ms(lambda: s_bare_fn(*s_args), 200)
    _require(torch.equal(s_out, next(r for r in rows if r["kernel"] == "K7")["out"]),
             "K7's bare call differs from its wrapper's")
    s_empty = _time_ms(lambda: s_empty_fn(*s_args), 200)
    # K7 reads v and writes the output whole, reads the indices and each target's last
    # d row, and adds once per component of a target.
    s_bound = _bound(2 * _nbytes(v) + _nbytes(idx) + uniq * w * 4, uniq * w)
    # K6 three ways: through the wrapper (gather_probe.main's k1), the bare C entry point
    # (bound once, pointers and stream taken beforehand) and torch.index_select, then the
    # same entry point's empty twin: what a ctypes call costs here.
    out = torch.empty_like(gather["out"])
    c_args = (v.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, m, w, build.raw_stream(dev))
    bare = build.bind("probe_gather", "probe_gather_launch", probes._GATHER_ARGS)
    noop = build.bind("probe_gather", "probe_gather_noop", probes._GATHER_ARGS)
    g_bare = _time_ms(lambda: bare(*c_args), 200)
    _require(torch.equal(out, gather["out"]), "K6's bare call differs from its wrapper's")
    wrap, lib = lambda: probes.probe_gather(v, idx), lambda: torch.index_select(v, 0, idx)
    turns = [_time_ms(fn, 200) for fn in (lib, wrap, wrap, lib, lib, wrap, wrap, lib)]
    g_wrap, g_lib = np.mean(turns[1::4] + turns[2::4]), np.mean(turns[0::4] + turns[3::4])
    t0 = time.perf_counter()
    for _ in range(200):
        noop(*c_args)
    g_noop = (time.perf_counter() - t0) * 1e3 / 200
    g_plain = _host_ms(lambda: probes._probe_gather_plain(v, idx))
    s_plain = _host_ms(lambda: probes._probe_scatter_plain(v, idx, d))
    scatter = next(r for r in rows if r["kernel"] == "K7")
    print(f"[22 probe gather/scatter] gather_probe.main: NB {nb}, M {m} ({uniq} distinct); "
          f"launches K6 {k6}, K7 {k7}; k1-k6 exact and repeated; k5 bit for bit and "
          f"repeated on {', '.join(c['label'][3:] for c in cases)}; "
          f"K6 (k1) {gather['ms']:.4f} ms, torch.index_select {gather['library_ms']:.4f} ms; "
          f"per call over 200 calls (4 runs each, in turns): K6 through its wrapper "
          f"{g_wrap:.4f} ms, torch.index_select {g_lib:.4f} ms; the bare C call "
          f"{g_bare:.4f} ms, an empty ctypes call of "
          f"the same 7 arguments {g_noop:.4f} ms (host clock); "
          f"plain {g_plain:.3f} ms, bound {g_bound[0]:.7f} ms ({g_bound[1]}); K7 "
          f"(k5) {scatter['ms']:.4f} ms per call in main; over 200 calls through its "
          f"wrapper {s_ms:.4f} ms, the bare C call {s_bare:.4f} ms, its grid of an empty "
          f"kernel through the same binding {s_empty:.4f} ms (the launch floor); plain "
          f"{s_plain:.3f} ms, bound {s_bound[0]:.7f} ms ({s_bound[1]})")
    return (dict(launches=k6, max_abs_err=0.0, ms=g_wrap, kernel_ms=g_bare, plain_ms=g_plain,
                 bound_ms=g_bound[0], bound_by=g_bound[1], library_ms=g_lib),
            dict(launches=k7, max_abs_err=0.0, ms=s_ms, kernel_ms=s_bare, plain_ms=s_plain,
                 bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=None))


# --- slice 10: the colosseum (sleep and wake under load), the cloth, every joint type ---

CLOTH = 64  # the card's lattice: 4,096 nodes, 16,002 links
CLOTH_SMALL = 16  # determinism and card vs CPU


def _track_steps(sim):
    """Record each step's overflow bits (device tensors, no host read) and which steps
    ``autosize`` ran. Returns (bits, marks): ``marks`` gets "before" / "after", the step
    counts at autosize's entry and return."""
    bits, marks = [], {}
    step, size = sim.timestep, sim.autosize

    def timestep(dt):
        step(dt)
        bits.append(sim.last_diag.overflow_src)

    def autosize(*a, **k):
        marks["before"] = len(bits)
        out = size(*a, **k)
        marks["after"] = len(bits)
        return out

    sim.timestep, sim.autosize = timestep, autosize
    return bits, marks


def _or_bits(bits):
    return int(np.bitwise_or.reduce(torch.stack(bits).cpu().numpy())) if bits else 0


def phase_colosseum(dev, name, smi, n_bodies, tag):
    """``bench.py``'s colosseum at ``n_bodies`` (``models.run_colosseum``: 33 steps,
    autosize, 33 steps, runs of 30 until under 5% awake, a timed settled window of 32, the
    topple of colosseum 0, a timed churn window of 32). Up to 8,192 body slots brute force
    and K1, above them grid2, the windowed layout and K2: that kernel once per step and no
    other solve kernel, no plain version. Gates: finite state, no overflow after autosize,
    every body above y = -0.2, settled under 5%, after the topple every awake body in
    colosseum 0 and at least half of it awake, the sleeping bodies' positions bit-equal
    over the settled window, 0 host syncs in both timed windows. Returns (the kernel's
    name, its launches)."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.models import build_colosseum_sim, run_colosseum

    t0 = time.perf_counter()
    sim, cfg, handles, col_of = build_colosseum_sim(n_bodies, device=dev)
    built = time.perf_counter() - t0
    kernel = "K1" if cfg.body_capacity <= 8192 else "K2"
    _require(len(handles) == n_bodies and (cfg.substeps, cfg.num_colors) == (4, 8),
             "colosseum configuration drifted from bench.py's")
    bits, marks = _track_steps(sim)
    syncs = []

    def window(sim, steps, dt):
        sps, per_step = _timed_syncs(sim, steps)
        syncs.append(per_step)
        return sps

    calls, restore = _count_plain_calls()
    _zero_launches()
    try:
        t0 = time.perf_counter()
        out = run_colosseum(sim, handles, col_of, DT, window=window)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        restore()
    launches = _kernel_launches()
    steps = len(bits)
    early, late = _or_bits(bits[:marks["before"]]), _or_bits(bits[marks["after"]:])
    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), f"{tag}: non-finite state")
    dyn = st.bodies.kind == KIND_DYNAMIC
    min_y = float(st.bodies.pos.y[dyn].min())
    hs = np.asarray(handles)
    col0 = {int(h) for h in hs[col_of == 0]}
    (p0, a0), (p1, _) = out["settled_window"]
    idx = torch.as_tensor(hs, device=p0.device)
    asleep = ~a0[idx]
    still = bool((p0[:, idx][:, asleep] == p1[:, idx][:, asleep]).all())
    n_asleep = int(asleep.sum())
    c = sim.config
    print(f"[{tag}] {n_bodies}-body colosseum ({len(set(col_of.tolist()))} colosseums of "
          f"{n_bodies // len(set(col_of.tolist()))}), built in {built:.1f} s, bench.py's "
          f"sequence in {steps} steps on {name} ({smi}), {elapsed:.1f} s: awake fraction "
          f"curve {[round(x, 4) for x in out['curve']]}, settled {out['settled']:.4f}, after "
          f"the topple {out['post_topple']:.4f} ({len(out['awake_handles'])} awake, all in "
          f"colosseum 0: {out['awake_handles'] <= col0}); {out['settled_sps']:.2f} steps/s "
          f"settled, {out['churn_sps']:.2f} churn; host syncs per step in the windows "
          f"{syncs}; launches {launches} ({launches[kernel] / steps:g} {kernel} per step), "
          f"plain calls {len(calls)}; overflow bits before autosize {early}, after {late}; "
          f"autosize {out['autosize']['rounds']} rounds, max_pairs {c.max_pairs}, wide_cap_rows "
          f"{c.wide_cap_rows}; {n_asleep} sleeping bodies bit-still over the settled window: "
          f"{still}; min dynamic y {min_y:.3f}")
    want = dict(K1=0, K2=0, K3=0, K4=0)
    want[kernel] = steps
    _require(launches == want, f"{tag}: the colosseum did not solve through {kernel} alone, "
             "once per step")
    _require(not calls, f"{tag}: a plain version ran on the card: {sorted(set(calls))}")
    _require(late == 0, f"{tag}: overflow after autosize (bits {late})")
    _require(min_y > -0.2, f"{tag}: a brick fell through the ground (y = {min_y})")
    _require(out["settled"] < 0.05, f"{tag}: settled at {out['settled']} awake")
    _require(out["awake_handles"] <= col0 and len(out["awake_handles"]) >= len(col0) // 2,
             f"{tag}: the topple woke bodies outside colosseum 0, or too few of it")
    _require(n_asleep > 0 and still, f"{tag}: a sleeping body moved in the settled window")
    _require(syncs == [0, 0], f"{tag}: host syncs in the timed windows: {syncs}")
    return kernel, launches[kernel]


def phase_determinism_colosseum(dev, steps=60):
    """Two runs of a small colosseum (2 rings of 24 bricks, 3 layers) on the card."""
    from bepuphysics2_tpu_torch.models import build_colosseum_sim

    hashes = []
    for _ in range(2):
        sim = build_colosseum_sim(144, ring_count=24, layers=3, device=dev)[0]
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    print(f"[25 determinism] 144-body colosseum, {steps} steps twice: state_hash "
          f"{hashes[0]:#018x} / {hashes[1]:#018x}")
    _require(hashes[0] == hashes[1], "two identical colosseum runs on the card differ")


def _link_strain(sim):
    """The largest |length / rest - 1| over the cloth's links."""
    bank = sim.joints["center_distance"].device(sim.device)
    pos = torch.stack(list(sim.state.bodies.pos), -1)
    a, b = bank["bodies"][:, 0].long(), bank["bodies"][:, 1].long()
    strain = (pos[a] - pos[b]).norm(dim=-1) / bank["prestep"][:, 0] - 1.0
    return float(strain[bank["valid"]].abs().max())


def phase_cloth(dev, name, smi, warm=64, timed=32, settle=104):
    """The 64 x 64 cloth (``models.build_cloth_sim``: 4,096 collidable nodes, 16,002
    ``center_distance`` links) dropped over a static sphere: ``warm`` steps, ``timed``
    timed steps, ``settle`` more. The nodes' contacts take the general path: the store
    bank through K3, substeps x iterations launches per step, beside the unified joint
    sweep; K1, K2 and K4 never, no plain version. Gates: finite, no overflow, no node
    below the ground, every link within 10% of its rest length at the end, 0 host syncs
    in the timed window. Returns K3's launches."""
    from bepuphysics2_tpu_torch.models import build_cloth_sim
    from bepuphysics2_tpu_torch.models.cloth import cloth_links

    t0 = time.perf_counter()
    sim, cfg, grid = build_cloth_sim(CLOTH, CLOTH, device=dev)
    built = time.perf_counter() - t0
    _require(sim.constraint_count == cloth_links(CLOTH, CLOTH) == 16002,
             "cloth configuration drifted")
    per_step = cfg.substeps * cfg.velocity_iterations
    bits, _ = _track_steps(sim)
    calls, restore = _count_plain_calls()
    _zero_launches()
    try:
        t0 = time.perf_counter()
        sim.run(warm, DT)
        sps, syncs = _timed_syncs(sim, timed)
        sim.run(settle, DT)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        restore()
    launches = _kernel_launches()
    steps = warm + timed + settle
    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.store.imp_pen, st.store.imp_tx, st.store.imp_ty, st.store.imp_tw,
              st.joint_impulses["center_distance"]]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), "cloth: non-finite state")
    nodes = torch.as_tensor(grid.reshape(-1), device=st.bodies.pos.y.device).long()
    min_y = float(st.bodies.pos.y[nodes].min())
    strain = _link_strain(sim)
    speed = float(torch.stack(list(st.bodies.vel), -1)[nodes].norm(dim=-1).max())
    ovf = _or_bits(bits)
    diag = sim.last_diag
    print(f"[27 cloth] {CLOTH} x {CLOTH} cloth ({len(nodes)} nodes, {sim.constraint_count} "
          f"links, {cfg.num_colors} colors, {cfg.substeps} substeps), built in {built:.1f} s, "
          f"{warm} + {timed} timed + {settle} steps on {name} ({smi}), {elapsed:.1f} s: "
          f"{sps:.2f} steps/s over the timed steps; host syncs per step {syncs:g}; launches "
          f"{launches} ({launches['K3'] / steps:g} K3 per step; by the structure "
          f"{per_step} joint sweeps per step, each {cfg.num_colors} color passes and a Jacobi "
          f"pass), plain calls {len(calls)}; overflow bits {ovf}; pairs {int(diag.pair_count)}, "
          f"contacts {int(diag.contact_count)}, Jacobi rows {int(diag.demand[5])}; min node y "
          f"{min_y:.3f}, largest speed {speed:.3f}; largest link strain at the end {strain:.4f}")
    _require(launches == dict(K1=0, K2=0, K3=per_step * steps, K4=0),
             f"the cloth did not solve its contacts through K3 alone, {per_step} per step")
    _require(not calls, f"a plain version ran on the card: {sorted(set(calls))}")
    _require(ovf == 0, f"the cloth overflowed (bits {ovf})")
    _require(min_y > 0.0, f"a node fell below the ground (y = {min_y})")
    _require(strain <= 0.1, f"a link is {strain:.3f} off its rest length")
    _require(int(diag.contact_count) > 0, "the cloth made no contacts")
    _require(syncs == 0, f"{syncs} host syncs per step in the timed window")
    return launches["K3"]


def phase_cloth_small(dev, steps=30, frames=30, tol=1e-4):
    """The 16 x 16 cloth: two runs of ``steps`` steps on the card bit-identical, and over
    ``frames`` frames of the CPU's run (the kernels' plain versions; the lattice lands on
    the sphere by frame 20) each card step from the CPU's state within ``tol`` of the
    CPU's (absolute and relative, K3's limit)."""
    from bepuphysics2_tpu_torch.models import build_cloth_sim

    hashes = []
    for _ in range(2):
        sim = build_cloth_sim(CLOTH_SMALL, CLOTH_SMALL, device=dev)[0]
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    worst, _ = _card_steps_from_states(sim, _cpu_result("27"))
    print(f"[27 determinism, cpu vs card] {CLOTH_SMALL} x {CLOTH_SMALL} cloth: {steps} steps "
          f"twice, state_hash {hashes[0]:#018x} / {hashes[1]:#018x}; {frames} frames, each "
          f"card step from the CPU's state within {worst:.3e} of the CPU's (limit {tol:g})")
    _require(hashes[0] == hashes[1], "two identical cloth runs on the card differ")
    _require(worst <= tol, "a card step of the cloth disagrees with the CPU's beyond K3's limit")


def phase_joint_rigs(dev, frames=3, tol=1e-4, steps=150):
    """Every joint type on the card (``models.joint_rigs``, the rig battery of
    ``tests/test_joint_behavior.py``): ``frames`` card steps from the CPU's carried state
    within ``tol`` (absolute and relative), then the battery's ``steps`` steps on the card
    and each rig's check; no host sync over 4 steps after one that pushes the checks'
    reads."""
    from bepuphysics2_tpu_torch.models.joint_rigs import ALL_NAMES, build_joint_rigs

    t0 = time.perf_counter()
    worst, _ = _card_steps_from_states(build_joint_rigs(dev, steps=0).sim, _cpu_result("28"))
    rigs = build_joint_rigs(dev, steps=steps)
    failed = []
    for rig, check in rigs.checks:
        try:
            check()
        except AssertionError as e:
            failed.append(f"{rig}: {e}")
    rigs.sim.run(1, DT)  # pushes the state the checks read back to the host
    _, syncs = _timed_syncs(rigs.sim, 4)
    covered = sorted({n for n, _ in rigs.checks})
    elapsed = time.perf_counter() - t0
    print(f"[28 joint types] {len(covered)} joint types, {len(rigs.checks)} rigs "
          f"({rigs.sim.body_count} bodies): {frames} card steps from the CPU's state within "
          f"{worst:.3e} of the CPU's (limit {tol:g}); after {steps} card steps {len(failed)} rigs "
          f"off their targets; host syncs per step {syncs:g} (5 more steps, the last 4 "
          f"counted); {elapsed:.1f} s")
    _require(syncs == 0, f"{syncs} host syncs per step on the rigs")
    _require(covered == sorted(ALL_NAMES) and len(covered) == 30, "a joint type has no rig")
    _require(worst <= tol, "a card step of the rigs disagrees with the CPU's")
    _require(not failed, f"rigs off their targets: {failed}")


# --- slice 11: the generic GJK/MPR narrow phase (K1), the car and the tank (K3) -----------


def five_shapes():
    """The shape mix of the reference's ShapePileBenchmark: a sphere, a capsule, a box, a
    cylinder and a convex hull of 24 points drawn on a sphere of radius 0.5 (seed 7)."""
    from bepuphysics2_tpu_torch import Box, Capsule, ConvexHull, Cylinder, Sphere

    pts = np.random.default_rng(7).normal(size=(24, 3))
    pts *= 0.5 / np.linalg.norm(pts, axis=1, keepdims=True)
    return (Sphere(0.5), Capsule(0.3, 0.4), Box(0.5, 0.5, 0.5), Cylinder(0.5, 0.4),
            ConvexHull.from_points(pts))


def _kernels_per_step(sim, steps=1):
    """CUDA kernels per step over ``steps`` steps (``torch.profiler`` kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run(steps, DT)
        torch.cuda.synchronize()
    return _cuda_events(prof) / steps


def _cuda_events(prof):
    """The device events (kernels, copies, fills) a finished ``torch.profiler`` run
    recorded, counted on its raw event list: the events ``key_averages`` would sum, without
    building its per-event objects (~1 s per 10,000 events on the host)."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:  # a torch without the raw list
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return sum(1 for e in events if e.device_type() == torch.autograd.DeviceType.CUDA)


# Phase 29's capacities, sized up front (``tools/five_shape_pile.py``): at bench.py's 8
# pairs per body the five-shape pile's broad phase peaks at 35,391 pairs, its store
# defers admissions from the first step and promotes up to 16,360 Jacobi rows while the
# pile collapses (overflow bit 4), and a hull fell through the ground at step 101,
# before bench.py's autosize; its shapes' larger bounds meet more neighbours. Sized here,
# the pile runs phase 4's sequence (33 steps, then the timed ones) with no autosize.
FIVE_SHAPE_CAPS = dict(max_pairs=65536, store_churn=8192, store_dead=8192,
                       store_repair=32768)


def phase_five_shape_pile(dev, name, smi, warm=33, timed=96):
    """Phase 29: the 4,096-body five-shape pile (``five_shapes`` in turn, ``build_pile``'s
    layout and settings: 4 substeps, 1 velocity iteration, 8 colors, brute force, the pair
    store and sleep on; ``FIVE_SHAPE_CAPS``) through ``warm`` steps and ``timed`` timed,
    as phase 4 runs the 4k pile. K1 once per step and no plain
    version, no host sync, the pile's gates (no overflow); K1 against its plain version on
    the last step's K1 call within 1e-4 and bit-identical on a repeat. The hulls come from
    the port's native quickhull. Returns (K1 launches, steps/s, kernels per step)."""
    from bepuphysics2_tpu_torch import native
    from bepuphysics2_tpu_torch.ops import sweep

    t0 = time.perf_counter()
    sim = build_pile(4096, dev, shapes=five_shapes(), **FIVE_SHAPE_CAPS)
    _require(native.load() is not None, "the hull was not built by the native quickhull")
    c = sim.config
    _require((c.body_capacity, c.substeps, c.velocity_iterations, c.num_colors)
             == (4160, 4, 1, 8) and c.enable_sleep and c.use_pair_store,
             "five-shape pile configuration drifted from bench.py's")
    before = _kernel_launches()
    calls, restore = _count_plain_calls()
    try:
        sim.run(warm, DT)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        t1 = time.perf_counter()
        sim.run(timed, DT)
        torch.cuda.synchronize()
        sps = timed / (time.perf_counter() - t1)
        _, syncs = _timed_syncs(sim, 4)
        k1_calls, _ = _k1_steps(sim, 1)
    finally:
        restore()
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    steps = warm + timed + 4 + 1
    min_y, pairs, contacts = _pile_gates(sim, "the five-shape pile")
    kps = _kernels_per_step(sim)
    args, kw = _clone_call(*k1_calls[-1])
    kern = lambda: sweep.solve_substeps_contacts(*args, **kw)
    plain = lambda: sweep._solve_substeps_contacts_plain(
        *args, **{k: v for k, v in kw.items() if k != "waves"})
    err, _ = _hold("K1", kern, plain, args[0], K1_TOL)
    print(f"[29 five-shape pile] 4096 bodies (sphere, capsule, box, cylinder, 24-point hull "
          f"of {len(five_shapes()[4].points)} vertices), {FIVE_SHAPE_CAPS}, {warm} + "
          f"{timed} steps on {name} ({smi}): {sps:.2f} steps/s over the {timed} timed "
          f"steps, warm-up {built:.1f} s; {kps:.0f} CUDA kernels per step; pairs {pairs}, "
          f"contacts {contacts}, min dynamic y {min_y:.3f}; launches {launches} over {steps} "
          f"steps, plain calls {len(calls)}, host syncs per step {syncs:g}; K1 vs plain on "
          f"the last step's call: max |diff| {err:.3e} (limit {K1_TOL:g}), bit-identical "
          f"repeat")
    _require(launches == dict(K1=steps, K2=0, K3=0, K4=0), "K1 did not launch once per step")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the five-shape pile")
    return launches["K1"], sps, kps


# Phase 30's limit on the largest |dpos| of the 256-body five-shape pile, card against
# CPU, over 20 frames. Sound runs read 2.578e-02 (the same body in each completed run of
# the phase; the CPU's own run moves as far under a 1e-7 nudge of the initial positions:
# landing contacts on cylinder rims and hull faces tie, ROADMAP queue 3); the control
# below, a card run that drops 8 bodies' ground contacts, reads ten times that (PERF.md).
FIVE_SHAPE_MAX = 5e-2
CONTROL_BODIES = (0, 1, 2, 3, 49, 50, 51, 52)  # bottom-layer bodies (a 7 x 7 x 7 grid)


def phase_five_shape_small(dev, steps=30, frames=20):
    """Phase 30: two card runs of a 512-body five-shape pile, ``steps`` steps each, give one
    ``state_hash``; a 256-body one on the card against the CPU over ``frames`` frames: the
    median |dpos| within 1e-4 and the largest within ``FIVE_SHAPE_MAX``. A control run on
    the card, with the ground and ``CONTROL_BODIES`` in one collision group (their ground
    contacts dropped, as a kernel that loses a few bodies' rows would), must exceed that
    limit, so that the limit tells a fault on a few bodies from the pile's own spread."""
    hashes = []
    for _ in range(2):
        sim = build_pile(512, dev, shapes=five_shapes())
        sim.run(steps, DT)
        torch.cuda.synchronize()
        hashes.append(sim.state_hash())
    runs = {"cpu": _cpu_result("30")}  # the CPU's run, in the CPU-side process
    for d in ("card", "control"):
        sim = build_pile(256, dev, shapes=five_shapes())
        if d == "control":
            sim._sync_from_device()
            h = sim._host
            h.collision_group[0] = 7  # the ground, handle 0
            h.collision_group[[b + 1 for b in CONTROL_BODIES]] = 7
            sim._dirty = True
        sim.run(frames, DT)
        runs[d] = positions(sim)
    diff = np.abs(runs["cpu"] - runs["card"])
    ctl = np.abs(runs["cpu"] - runs["control"]).max()
    print(f"[30 five-shape determinism, cpu vs card] 512 bodies, {steps} steps twice: "
          f"state_hash {hashes[0]:#018x} / {hashes[1]:#018x}; 256 bodies, {frames} frames: "
          f"max |dpos| {diff.max():.3e} (limit {FIVE_SHAPE_MAX:g}), median "
          f"{np.median(diff):.3e} (limit 0.0001); the control (8 bodies' ground contacts "
          f"dropped) {ctl:.3e} (above the limit)")
    _require(hashes[0] == hashes[1], "two identical five-shape runs on the card differ")
    _require(diff.max() <= FIVE_SHAPE_MAX and np.median(diff) <= 1e-4,
             "the card and the CPU disagree beyond the pile's own spread")
    _require(ctl > FIVE_SHAPE_MAX, "the control run stays within the limit")


def vehicle_world(kind, device):
    """``tests/test_models.py``'s car scene (``ground_sim(body_capacity=32)``: 4 substeps, 2
    velocity iterations, 8 colors, a ground box of half extent 50 with its top at 0, the
    car at (0, 0.8, 0)) or its tank scene (``body_capacity`` 64, ``max_pairs`` 1,024, 4
    substeps, 8 colors, no sleep, ``max_ccd_pairs`` 4, a ground box of half extent 120
    with its top at 0.25, the tank at (0, 1, 0) with 3 wheels a tread). Returns
    (simulation, model)."""
    from bepuphysics2_tpu_torch import Box, SimConfig, Simulation, StaticDescription
    from bepuphysics2_tpu_torch.models import SimpleCar, Tank

    if kind == "car":
        cfg = dict(body_capacity=32, max_pairs=512, substeps=4, velocity_iterations=2,
                   num_colors=8, joint_capacity=128, max_compound_pairs=16,
                   children_per_pair=4, child_window=16)
        ground, top = 50.0, -0.5
    else:
        cfg = dict(body_capacity=64, max_pairs=1024, substeps=4, num_colors=8,
                   joint_capacity=64, max_ccd_pairs=4, enable_sleep=False)
        ground, top = 120.0, -0.25
    sim = Simulation(SimConfig(**cfg), device=device)
    g = sim.add_shape(Box(ground, 0.5, ground))
    sim.add_static(StaticDescription(position=(0, top, 0), shape=g))
    if kind == "car":
        return sim, SimpleCar(sim, position=(0, 0.8, 0))
    return sim, Tank(sim, position=(0.0, 1.0, 0.0), wheels_per_tread=3)


def _yaw(q):
    x, y, z, w = q
    return np.arctan2(2 * (w * y + x * z), 1 - 2 * (y * y + z * z))


def _drive_car(sim, car):
    """``test_car_drives_forward``: 60 steps of 1/60 s to settle, then 180 at drive 8.
    Returns (steps, gates text, gates met)."""
    sim.run(60, DT)
    p0 = sim.get_body(car.body)[0]
    car.set_drive(8.0)
    sim.run(180, DT)
    p1 = sim.get_body(car.body)[0]
    dist = float(np.linalg.norm((p1 - p0)[[0, 2]]))
    return 240, f"drove {dist:.3f} m, body y {p1[1]:.3f}", dist > 1.0 and p1[1] > 0.2


def _drive_tank(sim, tank):
    """``test_tank_drives_turns_and_fires``: 30 steps to settle, 90 straight at track speeds
    (8, 8), 90 skid-steering at (6, -6), 120 aiming the turret a quarter turn, then a
    projectile fired (continuous, swept by CCD) and 10 more steps. Returns (steps, gates
    text, gates met)."""
    sim.run(30, DT)
    tank.set_track_speeds(8.0, 8.0)
    p0 = sim.get_body(tank.body)[0]
    sim.run(90, DT)
    p1, q0 = sim.get_body(tank.body)[0], sim.get_body(tank.body)[1]
    tank.set_track_speeds(6.0, -6.0)
    sim.run(90, DT)
    q1 = sim.get_body(tank.body)[1]
    tank.set_track_speeds(0.0, 0.0)
    tank.set_aim(np.pi / 2, 0.0)
    sim.run(120, DT)
    barrel = tank.barrel_direction()
    proj = tank.fire()
    launch = float(np.linalg.norm(sim.get_body(proj)[2]))
    sim.run(10, DT)
    shot = sim.get_body(proj)[0]
    fwd = p1 - p0
    dyaw = abs((_yaw(q1) - _yaw(q0) + np.pi) % (2 * np.pi) - np.pi)
    met = (abs(fwd[2]) > 0.8 and abs(fwd[2]) > 3 * abs(fwd[0]) and dyaw > 0.15
           and abs(barrel[0]) > 0.6 and launch > 0.8 * tank.projectile_speed
           and bool(np.isfinite(shot).all()))
    return 340, (f"drove dz {fwd[2]:.3f} dx {fwd[0]:.3f}, yaw {dyaw:.3f}, barrel x "
                 f"{barrel[0]:.3f}, fired at {launch:.1f} m/s (projectile_speed "
                 f"{tank.projectile_speed:g}), the shot at {np.round(shot, 2).tolist()} after "
                 f"10 steps"), met


def phase_vehicles(dev, name, smi, cpu_states, frames=3, tol=1e-4):
    """Phase 31: the car and the tank of ``tests/test_models.py``, each in its own scene on
    the card (``vehicle_world``) through that test's steps and gates: the car settles,
    then drives more than 1.0 m with its body above y = 0.2; the tank drives straight
    (|dz| above 0.8 and above 3|dx|), skid-steers (yaw above 0.15) and swivels its turret
    a quarter turn (the barrel's |x| above 0.6), then fires a projectile above 0.8 of its
    speed that stays finite over 10 steps (CCD on, ``max_ccd_pairs`` 4: K8 once a step).
    Per scene: K3 as often per step as substeps x iterations (the store bank beside the
    joints), K1, K2 and K4 never, no plain version; no host sync over 4 steps after one
    that pushes the gates' host edits and reads; ``frames`` card steps from the CPU's
    state (after 10 CPU steps: the wheels reach the ground) within ``tol``. Returns the
    K3 launches by scene and the tank's K8 launches. ``cpu_states``: the CPU sides
    "31 car" and "31 tank" by scene ("car", "tank"); the scenes it holds are run."""
    from bepuphysics2_tpu_torch.collision import sweeps

    out = {}
    for kind, drive in (("car", _drive_car), ("tank", _drive_tank)):
        if kind not in cpu_states:
            continue
        sim, model = vehicle_world(kind, dev)
        worst, _ = _card_steps_from_states(sim, cpu_states[kind])
        cfg = sim.config.solve_config()
        per_step = sum(cfg.iterations_for(s) for s in range(cfg.substeps))
        before, k8_before = _kernel_launches(), sweeps.conservative_advance.launches
        calls, restore = _count_plain_calls()
        t0 = time.perf_counter()
        try:
            steps, gates, met = drive(sim, model)
            torch.cuda.synchronize()
            sps = steps / (time.perf_counter() - t0)
            sim.run(1, DT)  # pushes the host edits and reads of the gates
            _, sync = _timed_syncs(sim, 4)
        finally:
            restore()
        steps += 5
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        k8 = sweeps.conservative_advance.launches - k8_before
        kps = _kernels_per_step(sim)
        types = sorted(sim._joint_banks())
        print(f"[31 {kind}] {sim.body_count} bodies, {len(types)} joint types, {steps} steps "
              f"on {name} ({smi}): {gates}; {sps:.2f} steps/s over the gates' steps, "
              f"{kps:.0f} CUDA kernels per step; launches {launches} (K3 {per_step} per "
              f"step), K8 {k8}, plain calls {len(calls)}, host syncs per step {sync:g}; "
              f"{frames} card "
              f"steps from the CPU's state within {worst:.3e} (limit {tol:g})")
        _require(met, f"the {kind} missed its gates: {gates}")
        _require(launches == dict(K1=0, K2=0, K3=per_step * steps, K4=0),
                 f"the {kind} did not solve through K3 {per_step} times per step")
        _require(k8 == (steps if kind == "tank" else 0),
                 f"K8 launched {k8} times in {steps} steps of the {kind}")
        _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
        _require(sync == 0, f"{sync} host syncs per step on the {kind}")
        _require(worst <= tol, f"a card step of the {kind} disagrees with the CPU's")
        out[kind] = launches["K3"]
        if kind == "tank":
            out["tank K8"] = k8
    return out


def _vehicles_proc(out_path, name, smi, cpu_states, start):
    """Phase 31's scenes of ``cpu_states`` in a process of their own: ``phase_vehicles``
    on card 0, its lines timed from the main process's ``start`` (the same monotonic
    clock), its result or its failure pickled to ``out_path``."""
    import pickle
    import traceback

    global _START
    _START = start
    torch.set_num_threads(1)
    try:
        torch.cuda.set_device(0)
        out = phase_vehicles(torch.device("cuda", 0), name, smi, cpu_states)
    except Exception:  # noqa: BLE001  (handed to the main process, which raises)
        out = dict(error=traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _start_vehicles(name, smi):
    """Starts phase 31 with its CPU sides: the car and the tank, each in a process of its
    own (``_vehicles_proc``). Both are bound by the host's ~160,000 launches a step, with
    the card idle most of that time, so they step beside the phases that follow and beside
    each other. Returns the handle ``_join_procs`` takes."""
    import multiprocessing as mp

    root = Path("build") / f"vehicles_{time.time_ns()}"
    root.mkdir(parents=True)
    procs, outs = [], []
    for kind in ("car", "tank"):
        cpu_states = {kind: _cpu_result(f"31 {kind}")}
        outs.append(root / f"phase31_{kind}.pkl")
        procs.append(mp.get_context("spawn").Process(
            target=_vehicles_proc, daemon=True,
            args=(str(outs[-1]), name, smi, cpu_states, _START)))
        procs[-1].start()
    return dict(procs=procs, outs=outs)


def _vehicle_paths(handle):
    """Phase 31's results from its processes → each of its paths' (kernel, launches)."""
    vehicles = {k: v for res in _join_procs(handle, "phase 31's process") for k, v in
                res.items()}
    paths = {"tank's 345 steps, CCD on (phase 31)": ("K8", vehicles.pop("tank K8"))}
    paths.update((k, ("K3", n)) for k, n in vehicles.items())
    return paths


# --- slice 12: the mesh-terrain pile, the queries, the characters (K1, K3) ------------------

TERRAIN_CELLS = 60  # 60 x 60 cells of 2 m: 7,200 triangles, y = 0.5 sin(x/4) cos(z/4)
TERRAIN_BODIES = 4096
RAY_TOL, SWEEP_TOL = 1e-5, 1e-4
CPU_RAYS = 64  # the full-pass rays also held on the CPU


def _terrain_gates(sim, label):
    """Finite state, no overflow, and every dynamic body's centre above the surface.
    Returns the lowest centre height above the surface."""
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.models import terrain_height

    st = sim.state
    leaves = [*st.bodies.pos, *st.bodies.orn, *st.bodies.vel, *st.bodies.omega,
              st.ccache.penetration, st.store.imp_pen]
    _require(all(bool(torch.isfinite(t).all()) for t in leaves), f"{label}: non-finite state")
    dyn = (st.bodies.kind == KIND_DYNAMIC).cpu().numpy()
    p = [c.cpu().numpy()[dyn] for c in st.bodies.pos]
    margin = float((p[1] - terrain_height(p[0], p[2])).min())
    _require(margin > 0.0, f"{label}: a body sank below the terrain (margin {margin:.3f})")
    _require(not bool(sim.last_diag.overflow),
             f"{label}: overflow (src {int(sim.last_diag.overflow_src)})")
    return margin


def phase_terrain_pile(dev, name, smi, warm=33, timed=48):
    """Phase 32: 4,096 bodies (spheres, boxes and, one in eight, a two-box dumbbell
    compound) dropped on a static 60 x 60-cell height-field mesh
    (``models.build_terrain_pile_sim``): brute-force broad phase, every body a compound
    pair with the mesh, the dumbbells compound-vs-compound pairs (``max_cc_pairs``).
    ``warm`` steps to land, ``autosize``, then ``timed`` timed steps (48, half of
    bench.py's 96, to fit the run's clock): K1 once per step over the store's bank and
    the compound bank (no K2-K4, no plain version), no host sync, no overflow after
    autosize, every body above the terrain. Then two runs of a 64-body pile on 10 x 10
    cells, 20 steps each, give one ``state_hash``, and 10 card steps of that pile, each
    from the CPU's state, are within 1e-4 of the CPU's. Returns (the sim, K1 launches over
    the timed steps, steps/s)."""
    from bepuphysics2_tpu_torch.models import build_terrain_pile_sim

    t0 = time.perf_counter()
    n_bodies = TERRAIN_BODIES
    sim, _ = build_terrain_pile_sim(n_bodies, TERRAIN_CELLS, device=dev)
    sim.run(warm, DT)
    sized = sim.autosize(DT, probe_steps=8)
    src = int(sim.last_diag.overflow_src)
    c = sim.config
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    calls, restore = _count_plain_calls()
    before = _kernel_launches()
    try:
        t1 = time.perf_counter()
        sim.run(timed, DT)
        torch.cuda.synchronize()
        sps = timed / (time.perf_counter() - t1)
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        _, syncs = _timed_syncs(sim, 4)
    finally:
        restore()
    margin = _terrain_gates(sim, "the terrain pile")
    diag = sim.last_diag
    hashes = []
    for _ in range(2):
        small, _ = build_terrain_pile_sim(64, 10, device=dev)
        small.run(20, DT)
        torch.cuda.synchronize()
        hashes.append(small.state_hash())
    worst, _ = _card_steps_from_states(build_terrain_pile_sim(64, 10, device=dev)[0],
                                       _cpu_result("32"))
    print(f"[32 terrain pile] {n_bodies} bodies ({n_bodies // 8} dumbbells) on a "
          f"{TERRAIN_CELLS} x "
          f"{TERRAIN_CELLS}-cell mesh ({2 * TERRAIN_CELLS ** 2} triangles) on {name} "
          f"({smi}): {sps:.2f} steps/s over {timed} timed steps; {warm} steps, autosize "
          f"({sized['rounds']} rounds) and build {built:.1f} s; capacities after autosize: "
          f"max_pairs {c.max_pairs}, max_compound_pairs {c.max_compound_pairs}, max_cc_pairs "
          f"{c.max_cc_pairs}; overflow_src after autosize {src}, after the timed steps "
          f"{int(diag.overflow_src)}; pairs {int(diag.pair_count)}, contacts "
          f"{int(diag.contact_count)}, lowest centre above the terrain {margin:.3f}; launches "
          f"{launches} over {timed} steps (K1 {launches['K1'] / timed:g} per step), plain "
          f"calls {len(calls)}, host syncs per step {syncs:g}; 64 bodies, 20 steps twice: "
          f"state_hash {hashes[0]:#018x} / {hashes[1]:#018x}; 64 bodies on 10 x 10 cells, 10 "
          f"card steps from the CPU's state within {worst:.3e} (limit {K1_TOL:g})")
    _require(src == 0, f"overflow after autosize (src {src})")
    _require(launches == dict(K1=timed, K2=0, K3=0, K4=0), "K1 did not launch once per step")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the terrain pile")
    _require(hashes[0] == hashes[1], "two identical terrain runs on the card differ")
    _require(worst <= K1_TOL, "a card step of the terrain pile disagrees with the CPU's")
    return sim, launches["K1"], sps


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _hits(out, rows=None):
    """A RayHit or SweepHit as numpy arrays, ``rows`` of each."""
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])
    d = dict(hit=pick(out.hit.cpu().numpy()), t=pick(out.t.cpu().numpy()),
             body=pick(out.body.cpu().numpy()))
    if getattr(out, "normal", None) is not None:
        d["normal"] = np.stack([pick(c.cpu().numpy()) for c in out.normal], -1)
    if out.saturated is not None:
        d["saturated"] = pick(out.saturated.cpu().numpy())
    return d


def _hold_hits(label, card, cpu, tol):
    for k in ("hit", "body", "saturated"):
        if k in cpu:
            _require(np.array_equal(card[k], cpu[k]), f"{label}: {k} differs from the CPU's")
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in ("t", "normal") if k in cpu)
    _require(err <= tol, f"{label}: t or normal {err:.3e} from the CPU's (limit {tol:g})")
    return err


def _cpu_query_worker(jobs, results):
    """The CPU side of phase 33, in a process of its own while the card runs its side:
    ``("build", (n_bodies, cells))`` builds the terrain pile on the CPU (while the card
    runs phase 32); ``("state", (config, snapshot, prev_pairs))`` loads the card's config
    and state (``state_to_numpy``) into it; ``("call", (label, method, args, kwargs))``
    runs a query of ``Simulation`` on it and puts ``(label, result)`` (ray and sweep hits
    as numpy); None ends. An exception is put as ``("error", text)``."""
    import traceback

    from bepuphysics2_tpu_torch.interop import state_from_numpy
    from bepuphysics2_tpu_torch.models import build_terrain_pile_sim

    torch.set_num_threads(4)
    cpu = None
    try:
        for kind, payload in iter(jobs.get, None):
            if kind == "build":
                cpu, _ = build_terrain_pile_sim(*payload, device="cpu")
            elif kind == "state":
                config, snapshot, prev = payload
                cpu.config = config
                cpu._state = state_from_numpy(snapshot, "cpu")
                cpu._dirty = False
                if prev is not None:
                    cpu._prev_contact_pairs = prev
            else:
                label, method, args, kwargs = payload
                out = getattr(cpu, method)(*args, **kwargs)
                results.put((label, _hits(out) if hasattr(out, "hit") else out))
    except Exception:  # noqa: BLE001  (handed to the main process, which raises)
        results.put(("error", traceback.format_exc()))


def _start_cpu_worker():
    """The process of ``_cpu_query_worker``, told to build the terrain pile: (worker,
    jobs, results)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    jobs.cancel_join_thread()  # a worker stopped early must not hold this process's exit
    worker = ctx.Process(target=_cpu_query_worker, args=(jobs, results), daemon=True)
    worker.start()
    jobs.put(("build", (TERRAIN_BODIES, TERRAIN_CELLS)))
    return worker, jobs, results


def phase_queries(dev, sim, cpu_side):
    """Phase 33: every query of ``Simulation`` on phase 32's settled pile on the card,
    held against the same query on a CPU copy of that state, which a second process
    runs while the card runs its side: ``hit``, ``body`` (and ``saturated``) equal,
    ``t`` and the normal within 1e-5 for rays and ``t`` within 1e-4 for sweeps; each
    query's synced ms on the card (each query's first call on its layout: eager).

    - 4,096 rays (one a body, from above) at ``prune_k`` 0 and 16, held on the CPU over
      their first ``CPU_RAYS`` (each row is its own query); where a pruned ray is not
      ``saturated`` it equals the full pass.
    - One ray with ``exclude``.
    - 256 capsule sweeps at ``prune_k`` 0, held on the CPU over their first (a hit: the
      CPU takes ~10 s a row), and at 16, held over their first 16; where a pruned sweep is not
      ``saturated`` it equals the full pass, and the saturated count is printed (on this
      pile every pruned sweep is saturated: a mesh triangle's bound radius is its
      farthest corner from the mesh's origin, so every triangle enters at t = 0 and the
      first 16 fill the budget, in the JAX package too: ROADMAP queue 3); CUDA kernels a
      sweep call.
    - ``sweep_shape`` (a sphere) and the host's coarse ``sweep``; ``box_query``;
      ``contacts`` and ``live_contact_pairs``.
    - ``contact_events`` over 30 steps after a topple (64 bodies flung), ``began`` and
      ``ended`` non-empty, held on the CPU every 10th step.

    The graph replay of the sweeps and the ray cast is held to their eager runs by
    ``tests/test_torch_replay.py``'s ``cuda`` cases."""
    from bepuphysics2_tpu_torch import Capsule, Sphere
    from bepuphysics2_tpu_torch.collision import sweeps
    from bepuphysics2_tpu_torch.interop import state_to_numpy
    from bepuphysics2_tpu_torch.utils import replay

    n = sim.body_count - 1
    worker, jobs, results = cpu_side
    want = {}
    try:
        jobs.put(("state", (sim.config, state_to_numpy(sim.state), None)))
        cpu_call = lambda label, method, *a, **k: jobs.put(("call", (label, method, a, k)))
        rng = np.random.default_rng(12)
        pos = np.stack([c.cpu().numpy() for c in sim.state.bodies.pos], -1)[1:n + 1]
        notes, errs, card = [], {}, {}
        # One ray a body from above, down and slanted, onto the pile.
        o = (pos + rng.normal(scale=0.4, size=pos.shape) + np.array([0, 4.0, 0])).astype(np.float32)
        d = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (n, 1))
        d[::4] += rng.normal(scale=0.3, size=d[::4].shape).astype(np.float32)
        sub = slice(0, CPU_RAYS)
        for k in (0, 16):
            cpu_call(f"rays k={k}", "ray_cast", o[sub], d[sub], 10.0, prune_k=k)
        b = 1 + int(rng.integers(0, n))
        p = pos[b - 1]
        one_ray = ((p[0], p[1] + 3.0, p[2]), (0, -1, 0), 10.0)
        cpu_call("ray exclude", "ray_cast", *one_ray, exclude=b)
        # 256 capsule sweeps down onto the pile, spinning.
        cap = Capsule(0.3, 0.4)
        ps = (pos[rng.integers(0, n, 256)] + np.array([0, 3.0, 0])).astype(np.float32)
        vs = np.tile(np.array([0.0, -2.0, 0.0], np.float32), (256, 1))
        ws = rng.normal(scale=0.5, size=(256, 3)).astype(np.float32)
        held = {0: 1, 16: 16}  # sweeps held on the CPU at each prune_k
        for k, m in held.items():
            cpu_call(f"sweeps k={k}", "sweep_shape_batch", cap, ps[:m], vs[:m], max_t=3.0,
                     angular_velocities=ws[:m], prune_k=k)
        one_sweep = (Sphere(0.4), tuple(ps[0]), (0.0, -2.0, 0.0))
        cpu_call("sweep_shape", "sweep_shape", *one_sweep, max_t=3.0)
        coarse = (Sphere(0.4), tuple(ps[0]), (0.0, -1.0, 0.0), 10.0)
        cpu_call("sweep", "sweep", *coarse)
        box = ((-10.0, -1.0, -10.0), (10.0, 3.0, 10.0))
        cpu_call("box_query", "box_query", *box)
        cpu_call("contacts", "contacts")
        cpu_call("live_contact_pairs", "live_contact_pairs")

        # The card's side, while the CPU runs its own.
        for k in (0, 16):
            out, ms = _synced_ms(lambda: sim.ray_cast(o, d, 10.0, prune_k=k))
            card[f"rays k={k}"] = h = _hits(out)
            notes.append(f"{n} rays prune_k {k}: {ms:.1f} ms, {int(h['hit'].sum())} hits")
            if k:
                ok = ~h["saturated"]
                full = card["rays k=0"]
                same = all(np.array_equal(h[f][ok], full[f][ok]) for f in ("hit", "body"))
                _require(same and np.abs(h["t"][ok] - full["t"][ok]).max(initial=0.0) <= RAY_TOL,
                         "a pruned ray that is not saturated differs from the full pass")
                notes.append(f"{int(h['saturated'].sum())} saturated, the other "
                             f"{int(ok.sum())} equal to the full pass")
        out, ms = _synced_ms(lambda: sim.ray_cast(*one_ray, exclude=b))
        card["ray exclude"] = _hits(out)
        _require(int(out.body) != b, "the excluded body was hit")
        notes.append(f"a ray excluding body {b}: hit body {int(out.body)}, {ms:.1f} ms")
        k8_before = sweeps.conservative_advance.launches
        plain_calls = []  # built-in shapes only: K8, never the masked PyTorch loop
        for k in held:
            calls, restore = _count_plain_calls()
            try:
                with _capture_k8() as k8_calls:
                    out, ms = _synced_ms(lambda: sim.sweep_shape_batch(
                        cap, ps, vs, max_t=3.0, angular_velocities=ws, prune_k=k))
            finally:
                restore()
            plain_calls += calls
            if k == 0:
                k8_call = k8_calls[0]
            card[f"sweeps k={k}"] = h = _hits(out)
            note = f"256 capsule sweeps prune_k {k}: {ms:.1f} ms, {int(h['hit'].sum())} hits"
            if k:
                ok = ~h["saturated"]
                full = card["sweeps k=0"]
                same = all(np.array_equal(h[f][ok], full[f][ok]) for f in ("hit", "body"))
                _require(same and np.abs(h["t"][ok] - full["t"][ok]).max(initial=0.0)
                         <= SWEEP_TOL, "a pruned sweep that is not saturated differs from "
                                       "the full pass")
                note += (f", {int(h['saturated'].sum())} saturated, the other "
                         f"{int(ok.sum())} equal to the full pass")
                if not ok.any():
                    note += " (a degenerate case: every sweep saturated, ROADMAP queue 3)"
            notes.append(note)
        _require(card["sweeps k=0"]["hit"][:held[0]].all(),
                 "the full-pass sweeps held on the CPU hit nothing")
        k8_sweeps = sweeps.conservative_advance.launches - k8_before
        _require(not plain_calls, "a sweep without a custom shape ran the masked PyTorch loop")
        out, ms = _synced_ms(lambda: sim.sweep_shape(*one_sweep, max_t=3.0))
        card["sweep_shape"] = _hits(out)
        notes.append(f"sweep_shape {ms:.1f} ms, body {int(out.body)}; "
                     f"{_kernels_per_call(lambda: sim.sweep_shape(*one_sweep, max_t=3.0))} "
                     f"CUDA kernels a sweep call")
        card["sweep"], ms = _synced_ms(lambda: sim.sweep(*coarse))
        notes.append(f"sweep {ms:.1f} ms (body {card['sweep'][2]})")
        card["box_query"], ms = _synced_ms(lambda: sim.box_query(*box))
        _require(len(card["box_query"]) > 10, "the box query found too few bodies")
        notes.append(f"box_query {ms:.1f} ms ({len(card['box_query'])} bodies)")
        card["contacts"], ms = _synced_ms(sim.contacts)
        _require(len(card["contacts"]) > 0, "contacts() returned nothing")
        notes.append(f"contacts {ms:.1f} ms ({len(card['contacts'])} records)")
        card["live_contact_pairs"], ms = _synced_ms(sim.live_contact_pairs)
        notes.append(f"live_contact_pairs {ms:.1f} ms ({len(card['live_contact_pairs'])} pairs)")
        # contact_events over 30 steps after a topple: 64 bodies flung up and sideways.
        sim.contact_events()
        for h in range(1, n + 1, 64):
            sim.set_velocity(h, linear=(3.0, 6.0, 0.0))
        began, ended, ms_all = set(), set(), 0.0
        for step in range(1, 31):
            sim.timestep(DT)
            prev = set(sim._prev_contact_pairs)
            ev, ms = _synced_ms(sim.contact_events)
            ms_all += ms
            if step % 10 == 0:  # held on the CPU every 10th step
                card[f"events {step}"] = ev
                jobs.put(("state", (sim.config, state_to_numpy(sim.state), prev)))
                cpu_call(f"events {step}", "contact_events")
            began |= ev["began"]
            ended |= ev["ended"]
        _require(began and ended, "the topple began or ended no contact")
        notes.append(f"contact_events over 30 steps {ms_all / 30:.1f} ms a call, {len(began)} "
                     f"began, {len(ended)} ended")
        t_wait = time.perf_counter()
        jobs.put(None)
        while len(want) < len(card):
            label, res = results.get(timeout=900)
            _require(label != "error", f"the CPU side of phase 33 failed:\n{res}")
            want[label] = res
        wait = time.perf_counter() - t_wait
        worker.join(timeout=60)
    finally:
        if worker.is_alive():
            worker.terminate()
            worker.join()
    cut = {"rays k=0": sub, "rays k=16": sub, "sweeps k=0": slice(0, held[0]),
           "sweeps k=16": slice(0, held[16])}
    for label, got in card.items():
        if label in cut or label in ("ray exclude", "sweep_shape"):
            if label in cut:
                got = {k: v[cut[label]] for k, v in got.items()}
            tol = RAY_TOL if label.startswith("ray") else SWEEP_TOL
            errs[label] = _hold_hits(label, got, want[label], tol)
        else:
            _require(got == want[label], f"{label} differs from the CPU's")
    print(f"[33 queries] on phase 32's pile, each held to a CPU copy of its state "
          f"(largest t or normal gap {max(errs.values()):.3e}; the card then waited "
          f"{wait:.1f} s for the CPU's side): " + "; ".join(notes)
          + f"; the two sweep batches launched K8 {k8_sweeps} times, no eager loop")
    _require(k8_sweeps == 2, f"the two sweep batches launched K8 {k8_sweeps} times")
    replay.clear()
    return k8_call


def _kernels_per_call(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _cuda_events(prof)


def character_world(device, n=64):
    """``n`` characters (``models.Character``: a capsule of radius 0.3 and height 1, its
    rotation locked, a one-body linear motor) in an 8-wide grid 4 m apart, inside the
    mesh's cells, 1.2 m above
    phase 32's terrain mesh; ``tests/test_models.py``'s settings (4 substeps, 2 velocity
    iterations, 8 colors), with the terrain pile's ``child_window`` of 1,024 (64 of the
    mesh's clusters a pair). Returns (sim, characters)."""
    from bepuphysics2_tpu_torch import SimConfig, Simulation, StaticDescription
    from bepuphysics2_tpu_torch.models import Character, terrain_height, terrain_mesh

    sim = Simulation(SimConfig(body_capacity=n + 64, max_pairs=1024, substeps=4,
                               velocity_iterations=2, num_colors=8, joint_capacity=128,
                               max_compound_pairs=256, children_per_pair=8,
                               child_window=1024),
                     device=device)
    sim.add_static(StaticDescription(position=(0.0, 0.0, 0.0),
                                     shape=sim.add_shape(terrain_mesh(TERRAIN_CELLS))))
    chars = []
    for i in range(n):
        # Off the cells' edges: a character dropped on a vertex of the mesh can rest on
        # the ridge there with its centre 0.916 m above the surface below it, beyond its
        # support ray's 0.9 m, and a support ray down a triangle's edge can pass between
        # the two triangles (Moller-Trumbore in float32, both packages): each character
        # starts, and ends its circle, 0.5 m from a cell's sides and 0.7 m from its
        # diagonal.
        x, z = 4.0 * (i % 8) - 13.5, 4.0 * (i // 8) - 13.5
        chars.append(Character(sim, position=(x, float(terrain_height(x, z)) + 1.2, z)))
    return sim, chars


def _heights(sim):
    """Every body's position, read to the host at once: (N, 3)."""
    return torch.stack(list(sim.state.bodies.pos), -1).cpu().numpy()


def phase_characters(dev, name, smi, land=60, walk=60, stand=60, flight=30, speed=3.0):
    """Phase 34: 64 characters on phase 32's terrain (no pile), over K3, in the sequence
    of ``tests/test_models.py``'s character test: ``land`` ticks, then every character
    supported (one ray cast each, read to the host: one sync by the JAX package's
    design); ``walk`` ticks of ``move`` once a tick along half a circle at ``speed`` m/s
    (60 ticks, half the test's 120, to fit the run's clock), every character more than 1
    m from where it landed at some tick; ticks of ``move((0,
    0))`` until every character is supported again, at most ``stand`` (on the terrain a
    character that stops can bounce off the ground for a few ticks, where the test's flat
    ground has none); then one ``move`` with a jump (5 m/s) each, every character jumping
    (supported), and up to ``flight`` ticks until
    every character has risen more than 0.5 m above its height at the jump (the test's
    thresholds). K3 every tick as often as 2 banks x substeps x iterations, K1, K2 and K4
    never, no plain version. Returns (K3 launches, ticks/s)."""
    sim, chars = character_world(dev)
    n = len(chars)
    rows = [c.body for c in chars]
    cfg = sim.config.solve_config()
    # K3 runs each contact bank once per substep iteration: the store's bank and the
    # compound bank (the capsules on the mesh).
    per_tick = 2 * sum(cfg.iterations_for(s) for s in range(cfg.substeps))
    calls, restore = _count_plain_calls()
    before = _kernel_launches()
    t0 = time.perf_counter()
    try:
        sim.run(land, DT)
        supported = [c.supported() for c in chars]
        start = _heights(sim)[rows]
        t1 = time.perf_counter()
        far = np.zeros(n)
        for k in range(walk):
            th = np.pi * k / walk
            for c in chars:
                c.move((speed * np.cos(th), speed * np.sin(th)))
            sim.timestep(DT)
            far = np.maximum(far, np.hypot(*(_heights(sim)[rows] - start)[:, [0, 2]].T))
        walk_tps = walk / (time.perf_counter() - t1)
        stood = 0
        while stood < stand:
            for c in chars:
                c.move((0.0, 0.0))
            sim.timestep(DT)
            stood += 1
            if all(c.supported() for c in chars):
                break
        base = _heights(sim)[rows, 1]
        for c in chars:
            c.move((0.0, 0.0), jump_speed=5.0)
        jumped = torch.stack(list(sim.state.bodies.vel), -1).cpu().numpy()[rows, 1] >= 4.99
        top = base.copy()
        ticks = land + walk + stood
        for _ in range(flight):
            sim.timestep(DT)
            ticks += 1
            top = np.maximum(top, _heights(sim)[rows, 1])
            if (top - base).min() > 0.5:
                break
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        import warnings

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for c in chars:
                    c.move((1.0, 0.0))
                sim.timestep(DT)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        restore()
    ticks += 1
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    rise = top - base
    print(f"[34 characters] {n} characters on the {TERRAIN_CELLS} x {TERRAIN_CELLS}-cell mesh "
          f"on {name} ({smi}): {ticks / elapsed:.2f} ticks/s over {ticks} ticks "
          f"({walk_tps:.2f} while walking, {n} moves a tick); supported after {land} ticks "
          f"{sum(supported)} of {n}; walked at least {far.min():.3f} m (limit 1) over {walk} "
          f"ticks along half a circle at {speed:g} m/s; {stood} ticks standing until all were "
          f"supported, then one jump pressed each, {int(jumped.sum())} of {n} jumped, risen "
          f"at least {rise.min():.3f} m (limit 0.5) {ticks - land - walk - stood - 1} ticks "
          f"later; launches "
          f"{launches} (K3 {per_tick} per tick: 2 banks), plain calls {len(calls)}; host "
          f"syncs in a tick of {n} moves {syncs} (each move reads its support ray)")
    _require(all(supported), "a character is not supported after landing")
    _require(far.min() > 1.0, "a character did not walk 1 m")
    _require(jumped.all(), "a character pressed jump off the ground")
    _require(rise.min() > 0.5, "a character did not jump 0.5 m")
    _require(launches == dict(K1=0, K2=0, K3=per_tick * ticks, K4=0),
             f"the characters did not solve through K3 {per_tick} times per tick")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    return launches["K3"], ticks / elapsed


# --- slice 13: K8, CCD (queue 1 item 19) and the utilities (item 21) ----------------------

K8_SOURCE = "bepuphysics2_tpu_torch/csrc/conservative_advance.cu"
# No TPU kernel: the JAX package compiles this loop with XLA (its fori_loop in pair_toi).
K8_REPLACES = "none: XLA's loops, bepuphysics2_tpu/collision/sweeps.py:228 and :325"
# K8's own keys in the kernels line: each pass alone, the share pass 1 finishes, the bound
# of the wrapper before the tables, the lane efficiency of one thread a record, ptxas's.
K8_EXTRA = ("pass1_ms", "pass2_ms", "pass1_finished", "per_record_bound_ms",
            "lane_efficiency_one_thread", "ptxas")


class _capture_k8:
    """Records the advancement calls (``sweeps.advance``'s records, iterations and miss
    rule) inside a block: K8's inputs where no custom shape is present."""

    def __enter__(self):
        from bepuphysics2_tpu_torch.collision import sweeps

        self.real, calls = sweeps.advance, []

        def spy(rec, custom_ids, iters=sweeps.SWEEP_ITERS, miss_max_t=False):
            calls.append((rec, iters, miss_max_t))
            return self.real(rec, custom_ids, iters, miss_max_t)

        sweeps.advance = spy
        return calls

    def __exit__(self, *exc):
        from bepuphysics2_tpu_torch.collision import sweeps

        sweeps.advance = self.real
        return False


def _records(x, rows):
    """The records ``rows`` of K8's flat input ``x`` (the hull pool whole)."""
    if torch.is_tensor(x):
        return x[rows]
    if isinstance(x, dict):
        return {k: v if k == "hull_points" else _records(v, rows) for k, v in x.items()}
    return type(x)(*(_records(v, rows) for v in x))


def _k8_ops(rec):
    """(operations of one advancement iteration outside GJK's loop, of one GJK iteration),
    counted on the plain version (``sweeps._advance``) for the first record of ``rec``."""
    from bepuphysics2_tpu_torch.collision import convex, sweeps

    dev = rec.a.f.device
    first = (torch.zeros(1, 2, dtype=torch.int32, device=dev) if rec.pairs is None
             else rec.pairs[:1])
    one = _to_cpu(sweeps.gather_records(rec._replace(
        pairs=first, exists=torch.ones(1, dtype=torch.bool, device=dev))))
    full = convex.GJK_ITERS
    try:
        convex.GJK_ITERS = 0
        adv = _ops_per_item(sweeps._advance, one, (), 1)
        convex.GJK_ITERS = 1
        gjk = _ops_per_item(sweeps._advance, one, (), 1) - adv
    finally:
        convex.GJK_ITERS = full
    return adv, gjk


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return type(x)(*(_to_cpu(v) for v in x))


def _ptxas(name):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill load bytes)} from
    the newest build log of ``csrc/<name>.cu`` (``-Xptxas=-v``)."""
    import re

    from bepuphysics2_tpu_torch.ops import build

    out, kernel, frame = {}, None, None
    for line in build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = next((k for k in ("advance_first", "advance_rest") if k in m.group(1)),
                          m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and kernel:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel] = (int(m.group(1)),) + (frame or (0, 0, 0))
            kernel, frame = None, None
    return out


def _lane_efficiency(work):
    """Sum of ``work`` over sum over warps (32 consecutive records) of 32 x the warp's
    largest: the share of a one-thread-a-record kernel's lane time that does work, in
    the records' own order."""
    n = work.shape[0]
    w = torch.nn.functional.pad(work.double(), (0, -n % 32)).reshape(-1, 32)
    return float(w.sum() / (32 * w.amax(1)).sum())


def _k8_parts_ms(call, reps):
    """CUDA-event ms of K8's C entry point alone, on the arguments its wrapper makes
    (``call`` runs the wrapper once): both passes, pass 1 alone, then pass 2 alone over
    the queue pass 1 left."""
    from bepuphysics2_tpu_torch.collision import sweeps
    from bepuphysics2_tpu_torch.ops import build

    key = ("conservative_advance", "conservative_advance_launch")
    real, out = build._bound[key], {}
    at = len(sweeps._K8_ARGS) - 2  # the passes argument

    def spy(*args):
        err = real(*args)
        for label, passes in (("both", 3), ("pass 1", 1), ("pass 2", 2)):
            a = list(args)
            a[at] = passes
            out[label] = _time_ms(lambda: real(*a), reps)
        return err

    build._bound[key] = spy
    try:
        call()
    finally:
        build._bound[key] = real
    return out


def _k8_hold(dev, rec, iters, miss, label):
    """K8 against its plain version on the records ``rec``: every record bit for bit
    equal, and bit-identical on a repeat. Returns (work, queued, plain ms)."""
    from bepuphysics2_tpu_torch.collision import sweeps

    n = rec.n
    work = torch.zeros(n, 2, dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    got = sweeps.conservative_advance(rec, iters, miss, work=work, counters=counters)
    again = sweeps.conservative_advance(rec, iters, miss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sweeps.conservative_advance_plain(rec, iters, miss)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    unequal = int((got != want).sum())
    _require(unequal == 0, f"K8 parts from its plain version on {unequal} of {n} records of "
                           f"{label}")
    _require(bool((got == again).all()), f"K8 differs from itself on a repeat of {label}")
    return work, int(counters[0]), plain_ms


def _k8_bytes(rec):
    """The bytes K8's function must move: each table read once (the hull pool and the
    registry's pool rows too, and an explicit form's pairs and exists), the output
    written once."""
    t = [rec.a.f, rec.a.i, rec.b.f, rec.b.i, rec.hull_rows, *rec.hull_points]
    if rec.a.f.data_ptr() == rec.b.f.data_ptr():
        t = t[2:]  # one table on both sides
    if rec.pairs is not None:
        t += [rec.pairs, rec.exists]
    return _nbytes(*t) + 4 * rec.n


def phase_kernel_k8(dev, call, launches):
    """K8 against its plain version (``sweeps.conservative_advance_plain``: the records
    gathered from the tables, then ``sweeps._advance``) on phase 33's own K8 call, the
    256 capsule sweeps at ``prune_k`` 0 against every body and mesh triangle of the
    4,096-body terrain pile (the product form; phase 35 holds one of its CCD calls, the
    explicit form): every record bit for bit equal, and bit-identical on a repeat. Times
    on phase 33's call: the wrapper, the C entry point alone, pass 1 alone and pass 2
    alone over the queue pass 1 left (CUDA events), the plain version (one call, host
    clock); the share of records pass 1 finishes; the lane efficiency a one-thread-a-record
    kernel had on these records in their order (``_lane_efficiency`` of the advancement
    and of the GJK iterations); ptxas's registers, stack frame and spills of both passes.
    Bound: the bytes (each table read once, the output written once) against the
    operations the records needed (each record's advancement and GJK iterations, counted
    by K8, times their operations counted on the plain version); beside it the bound of
    the wrapper before the tables (every record's own 51 + H words read)."""
    from bepuphysics2_tpu_torch.collision import sweeps

    rec, iters, miss = call
    n = rec.n
    work, queued, plain_ms = _k8_hold(dev, rec, iters, miss, "phase 33's call")
    ms = _time_ms(lambda: sweeps.conservative_advance(rec, iters, miss), 5)
    parts = _k8_parts_ms(lambda: sweeps.conservative_advance(rec, iters, miss), 5)
    adv_ops, gjk_ops = _k8_ops(rec)
    w = work.sum(0).tolist()
    ops = w[0] * adv_ops + w[1] * gjk_ops
    bound_ms, bound_by = _bound(_k8_bytes(rec), ops)
    hull_width = rec.hull_rows.shape[1]
    old_bytes = n * (35 + 3 + 12 + hull_width + 1) * 4 + _nbytes(*rec.hull_points)
    old_bound_ms, old_by = _bound(old_bytes, ops)
    eff_adv, eff_gjk = _lane_efficiency(work[:, 0]), _lane_efficiency(work[:, 1])
    longest = work[int(torch.argmax(work[:, 1]))].tolist()
    ptx = _ptxas("conservative_advance")
    ptx_note = "; ".join(f"{k} {v[0]} registers, {v[1]} bytes stack, {v[2]} + {v[3]} bytes "
                         f"spill stores + loads" for k, v in sorted(ptx.items()))
    finished = 1.0 - queued / n
    print(f"[33 K8] conservative advancement on phase 33's call ({n} records, {iters} "
          f"iterations): every record bit for bit equal, repeat bit-identical; {w[0]} "
          f"advancement and {w[1]} GJK iterations run ({adv_ops} and {gjk_ops} operations "
          f"each); {ms:.3f} ms through the wrapper, {parts['both']:.3f} ms alone (pass 1 "
          f"{parts['pass 1']:.3f}, pass 2 {parts['pass 2']:.3f}), plain {plain_ms:.1f} ms; "
          f"pass 1 finished {finished:.4f} of the records ({queued} to pass 2); one thread "
          f"a record would have run its lanes at {eff_adv:.4f} (advancement) and "
          f"{eff_gjk:.4f} (GJK iterations); the longest record ran {longest[0]} "
          f"advancement and {longest[1]} GJK iterations; bound {bound_ms:.4f} ms ({bound_by}; the "
          f"per-record layout's {old_bound_ms:.4f}, {old_by}); ptxas: {ptx_note}")
    for k, v in ptx.items():
        if v[1] or v[2] or v[3]:
            print(f"[33 K8] ptxas: {k} keeps {v[1]} bytes of stack and spills {v[2]} + {v[3]} "
                  f"bytes")
    return dict(max_abs_err=0.0, ms=ms, kernel_ms=parts["both"], pass1_ms=parts["pass 1"],
                pass2_ms=parts["pass 2"], pass1_finished=finished, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, per_record_bound_ms=old_bound_ms,
                lane_efficiency_one_thread=dict(advancement=eff_adv, gjk=eff_gjk),
                ptxas={k: dict(registers=v[0], stack=v[1], spill_stores=v[2],
                               spill_loads=v[3]) for k, v in ptx.items()},
                launches=launches, library_ms=None)


CCD_SPHERES = 256
CCD_SPEED = 120.0  # m/s: 2 m a step at 1/60 s, 20 times a sphere's diameter


# The wall's half thickness: a CCD stop may overshoot by up to one substep of the
# clamped approach (tests/test_ccd.py's compound-panel test sizes its panel for it), here
# 120 m/s over 1/240 s = 0.5 m; past the wall's centre plane the sphere is pushed out
# of its far face. So the gated wall is 1 m thick, and a 0.4 m wall (Box(0.2, h, w)) is
# run at 512 bodies and its crossings printed (ROADMAP queue 3).
CCD_WALL, THIN_WALL = 0.5, 0.2


def ccd_world(n_bodies, n_spheres, device, ccd_pairs, speculative=True, wall=CCD_WALL):
    """Phase 4's pile (``build_pile``: ``bench.py``'s layout and solver settings, brute
    force) with a static ``Box(wall, h, w)`` wall behind it that covers its face, 33
    landing steps, then ``n_spheres`` continuous ``Sphere(0.1)`` of mass 0.1 (as
    ``tests/test_ccd.py``'s bullet) fired along +x at ``CCD_SPEED`` from 3 m before the
    pile, spread over its face (numpy seed 13). ``speculative`` False gives the spheres
    no speculative margin (discrete contacts only). Returns (sim, sphere handles, the
    wall's far face x)."""
    from bepuphysics2_tpu_torch import BodyDescription, Box, Sphere, StaticDescription

    sim = build_pile(n_bodies, device, max_ccd_pairs=ccd_pairs,
                     body_capacity=n_bodies + n_spheres + 64)
    side = max(1, int(np.ceil(n_bodies ** (1 / 3))))
    half = 0.6 * side
    wall_x = half + 1.3 + wall
    sim.add_static(StaticDescription(position=(wall_x, half, 0.0),
                                     shape=sim.add_shape(Box(wall, half + 2.0, half + 2.0))))
    sim.run(33, DT)
    s = Sphere(0.1)
    ss = sim.add_shape(s)
    rng = np.random.default_rng(13)
    margins = {} if speculative else dict(speculative_margin=0.0, speculative_margin_max=0.0)
    handles = [sim.add_body(BodyDescription.dynamic(
        (-half - 3.0, rng.uniform(0.3, 1.0 + 0.9 * side), rng.uniform(-half, half)), ss, 0.1,
        s, velocity=(CCD_SPEED, 0.0, 0.0), continuity=1, **margins)) for _ in range(n_spheres)]
    return sim, handles, wall_x + wall


def _past(sim, handles, far):
    xs = sim.state.bodies.pos.x[torch.as_tensor(handles, device=sim.device)]
    return int((xs > far).sum())


class _risk_peak:
    """The largest count of CCD risk pairs of any step inside a block, kept on the device
    (the count ``narrowphase._ccd_times`` compacts): read once, after the block."""

    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        from bepuphysics2_tpu_torch.collision import narrowphase

        self.real = narrowphase.compact_true
        self.peak = None

        def spy(mask, size, *a):
            sel, count = self.real(mask, size, *a)
            if size == self.cap:
                self.peak = count if self.peak is None else torch.maximum(self.peak, count)
            return sel, count

        narrowphase.compact_true = spy
        return self

    def __exit__(self, *exc):
        from bepuphysics2_tpu_torch.collision import narrowphase

        narrowphase.compact_true = self.real
        return False


def phase_ccd(dev, name, smi, steps=48, ccd_pairs=16384):
    """Phase 35: CCD at full width. Phase 4's 4,096-body pile, 33 landing steps, then 256
    continuous spheres at 120 m/s into it toward a thin static wall behind it
    (``ccd_world``, a 1 m wall), ``max_ccd_pairs`` 16,384, ``steps`` timed steps: every
    state value finite, no overflow, K1 once a step, K8 as often as the passes say (one
    body-level pass a step: no compound), no plain version, no host sync, no sphere beyond
    the wall's far face; the largest risk count of a step beside the capacity. Then 512
    bodies and 32 spheres, 30 steps twice: one ``state_hash``; the same scene with
    ``max_ccd_pairs`` 0 and the spheres' speculative margin 0 (discrete contacts alone)
    must let a sphere through the wall, or the wall's gate proves nothing; the same scene
    with CCD and a 0.4 m wall, its crossings printed (the solver's overshoot, ROADMAP
    queue 3); and 64 bodies with 8 spheres, 10 card steps each from the CPU's state within
    1e-4 of the CPU's. K8 on the last timed step's call (the explicit form) bit for bit
    equal to its plain version and to itself on a repeat. Returns K8's launches over the
    timed steps."""
    from bepuphysics2_tpu_torch.collision import sweeps

    sim, spheres, far = ccd_world(4096, CCD_SPHERES, dev, ccd_pairs)
    calls, restore = _count_plain_calls()
    before, k8_before = _kernel_launches(), sweeps.conservative_advance.launches
    try:
        with _risk_peak(ccd_pairs) as risk, _capture_k8() as k8_calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(steps, DT)
            torch.cuda.synchronize()
            sps = steps / (time.perf_counter() - t0)
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        k8 = sweeps.conservative_advance.launches - k8_before
        _, syncs = _timed_syncs(sim, 4)
    finally:
        restore()
    min_y, pairs, contacts = _pile_gates(sim, "the CCD pile")
    past = _past(sim, spheres, far)
    peak = int(risk.peak)
    # K8 held on the last step's call (the explicit form: the body table on both sides).
    rec, iters, miss = k8_calls[-1]
    del k8_calls
    _, queued, _ = _k8_hold(dev, rec, iters, miss, "phase 35's last CCD call")
    k8_ms = _time_ms(lambda: sweeps.conservative_advance(rec, iters, miss), 5)
    held = (f"K8 on the last step's call ({rec.n} records, {int(rec.exists.sum())} live, "
            f"{iters} iterations) bit for bit equal to its plain version and to itself on a "
            f"repeat, {queued} records left to pass 2, {k8_ms:.3f} ms through the wrapper")
    del rec
    hashes = []
    for _ in range(2):
        small, _, _ = ccd_world(512, 32, dev, 2048)
        small.run(30, DT)
        torch.cuda.synchronize()
        hashes.append(small.state_hash())
    control, c_spheres, c_far = ccd_world(512, 32, dev, 0, speculative=False)
    control.run(30, DT)
    through = _past(control, c_spheres, c_far)
    thin, t_spheres, t_far = ccd_world(512, 32, dev, 2048, wall=THIN_WALL)
    thin.run(30, DT)
    thin_through = _past(thin, t_spheres, t_far)
    worst, _ = _card_steps_from_states(ccd_world(64, 8, dev, 512)[0], _cpu_result("35"))
    print(f"[35 ccd] 4096-body pile and {CCD_SPHERES} continuous spheres at {CCD_SPEED:g} m/s "
          f"into it toward a {2 * CCD_WALL:g} m wall, on {name} ({smi}): {sps:.2f} steps/s "
          f"over {steps} timed steps; spheres beyond the wall {past}; the largest risk count of a step "
          f"{peak} (max_ccd_pairs {ccd_pairs}); pairs {pairs}, contacts {contacts}, min "
          f"dynamic y {min_y:.3f}; launches {launches} and K8 {k8} over {steps} steps "
          f"({k8 / steps:g} a step), plain calls {len(calls)}, host syncs per step "
          f"{syncs:g}; {held}; 512 bodies and 32 spheres, 30 steps twice: state_hash "
          f"{hashes[0]:#018x} / {hashes[1]:#018x}; the control (max_ccd_pairs 0, "
          f"discrete contacts alone): {through} of 32 spheres through the wall; CCD on and a "
          f"{2 * THIN_WALL:g} m wall: {thin_through} of 32 through; 64 bodies "
          f"and 8 spheres, 10 card steps from the CPU's state within {worst:.3e} (limit "
          f"{K1_TOL:g})")
    _require(past == 0, f"{past} spheres went through the wall")
    _require(peak <= ccd_pairs, f"{peak} risk pairs in a step, beyond {ccd_pairs}")
    _require(launches == dict(K1=steps, K2=0, K3=0, K4=0), "K1 did not launch once per step")
    _require(k8 == steps, f"K8 launched {k8} times in {steps} steps")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the CCD pile")
    _require(hashes[0] == hashes[1], "two identical CCD runs on the card differ")
    _require(through > 0, "the control let no sphere through: the wall's gate proves nothing")
    _require(worst <= K1_TOL, "a card step of the CCD pile disagrees with the CPU's")
    return k8


def phase_utilities(dev, sim):
    """Phase 36: queue 1 item 21 on phase 4's pile after its timed steps: a checkpoint, 20
    steps, the checkpoint loaded and the same 20 steps give one ``state_hash``; ``validate``
    passes; ``simulation_metrics`` is finite and within 1e-4 (relative) of the same
    function on a CPU copy of the state; ``profile_stages`` times each stage on the card;
    ``TraceSession`` writes a non-empty trace (under ``build/traces``)."""
    import os

    from bepuphysics2_tpu_torch import TraceSession, simulation_metrics, validate
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy
    from bepuphysics2_tpu_torch.metrics import compute_metrics
    from bepuphysics2_tpu_torch.profiling import profile_stages

    data = sim.save_checkpoint()
    sim.run(20, DT)
    first = sim.state_hash()
    sim.load_checkpoint(data)
    sim.run(20, DT)
    second = sim.state_hash()
    validate(sim)
    got = simulation_metrics(sim)
    cpu_state = state_from_numpy(state_to_numpy(sim.state), "cpu")
    want = compute_metrics(cpu_state, sim.shapes.device("cpu"), sim.config)
    gap = 0.0
    for f in got._fields:
        g, w = getattr(got, f).cpu().double(), getattr(want, f).double()
        _require(bool(torch.isfinite(g).all()), f"metric {f} is not finite")
        gap = max(gap, float(((g - w).abs() / (1.0 + w.abs())).max()))
    stages = profile_stages(sim, DT, iters=10)
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")
    with TraceSession(log_dir) as trace:
        sim.run(2, DT)
    size = os.path.getsize(trace.path)
    print(f"[36 utilities] on phase 4's pile: checkpoint, 20 steps, restore, 20 steps: "
          f"state_hash {first:#018x} / {second:#018x} ({len(data)} bytes); validate passed; "
          f"metrics within {gap:.3e} of the CPU's (kinetic energy "
          f"{float(got.kinetic_energy):.4f}, {int(got.contact_count)} contacts); stage ms "
          + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in stages.items())
          + f"; TraceSession wrote {size} bytes")
    _require(first == second, "the steps after a restored checkpoint differ")
    _require(gap <= 1e-4, f"the card's metrics part from the CPU's by {gap:.3e}")
    _require(size > 0, "the trace is empty")


# --- slice 14: the legacy per-frame path (K1, K3), the sweep and grid broad phases,
# batched worlds and the constraint-sharded step --------------------------------------

LEGACY = dict(use_pair_store=False)
BATCHED_WORLDS = 8  # phase 39: 512-body piles of seeds 0-7
SHARD_BODIES = 1024  # phase 40's pile
SHARD_JOINTS = 8  # ball sockets between z-neighbours of its first rows
SHARD_STEPS = 20
SHARD_TIMEOUT_S = 300  # every rendezvous, collective and join of phase 40


def legacy_tube(n_ragdolls, device):
    """The ragdoll tube at the package's default solver settings, 2 substeps and 4 colors,
    on the legacy per-frame path: its convex records and its compound children each a
    contact bank through K3, beside the joint sweep."""
    sim = tube_sim(n_ragdolls, device, substeps=2, num_colors=4, bench=False)
    sim.config = dataclasses.replace(sim.config, **LEGACY)
    sim._dirty = True
    return sim


def phase_legacy_pile(dev, name, smi, warm=33, timed=32):
    """Phase 37: the 4,096-body pile of phase 4 at bench.py's settings on the legacy
    per-frame path (``use_pair_store=False``): ``warm`` landing steps, then ``timed`` timed.
    Per step the candidates' records join last frame's cache, the general path colors and
    buckets them (slices of 512 rows), and one K1 launch solves them: K1 once a step, no
    plain version, 0 host syncs (4 steps more), the pile's gates. Returns (the
    simulation, K1 launches)."""
    t0 = time.perf_counter()
    sim = build_pile(4096, dev, **LEGACY)
    calls, restore = _count_plain_calls()
    before = _kernel_launches()
    try:
        sim.run(warm, DT)
        torch.cuda.synchronize()
        landed = time.perf_counter() - t0
        t1 = time.perf_counter()
        sim.run(timed, DT)
        torch.cuda.synchronize()
        sps = timed / (time.perf_counter() - t1)
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        _, syncs = _timed_syncs(sim, 4)
    finally:
        restore()
    min_y, pairs, contacts = _pile_gates(sim, "the legacy 4k pile")
    diag = sim.last_diag
    print(f"[37 legacy pile] 4096-body pile on the legacy per-frame path, {warm} + {timed} "
          f"steps on {name} ({smi}): {sps:.2f} steps/s over the {timed} timed steps; landing "
          f"{landed:.1f} s; pairs {pairs}, contacts {contacts}, peak Jacobi rows "
          f"{int(diag.demand[5])}, min dynamic y {min_y:.3f}; launches {launches}, plain "
          f"calls {len(calls)}, host syncs per step {syncs:g}")
    _require(launches == dict(K1=warm + timed, K2=0, K3=0, K4=0),
             "K1 did not launch once per step on the legacy pile")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the legacy pile")
    return sim, launches["K1"]


def phase_legacy_tube(dev, frames=6, steps=4, tol=1e-4):
    """Phase 37's tube: the 4-ragdoll ``legacy_tube``. Each of the CPU's ``frames`` steps
    (``_start_cpu_side``), stepped again on the card from the CPU's state before it, within
    ``tol`` of the CPU's (absolute and relative); then ``steps`` card steps with the
    launches counted: K3 once per contact bank per substep (two banks, 2 substeps, one
    iteration: 4 a step), nothing else, no plain version, 0 host syncs. Returns K3's
    launches over those steps."""
    sim = legacy_tube(4, dev)
    worst, _ = _card_steps_from_states(sim, _cpu_result("37t"))
    sim.run(2, DT)
    calls, restore = _count_plain_calls()
    before = _kernel_launches()
    try:
        sim.run(steps, DT)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _kernel_launches().items()}
        _, syncs = _timed_syncs(sim, 4)
    finally:
        restore()
    print(f"[37 legacy tube] 4-ragdoll tube on the legacy path: {frames} card steps from "
          f"the CPU's state within {worst:.3e} of the CPU's (limit {tol:g}); launches over "
          f"{steps} steps {launches}, plain calls {len(calls)}, host syncs per step {syncs:g}")
    _require(worst <= tol, "a card step of the legacy tube disagrees with the CPU's")
    _require(launches == dict(K1=0, K2=0, K3=4 * steps, K4=0),
             "K3 did not launch once per contact bank per substep on the legacy tube")
    _require(not calls, f"plain versions ran on the card: {sorted(set(calls))}")
    _require(syncs == 0, f"{syncs} host syncs per step on the legacy tube")
    return launches["K3"]


def phase_broadphases(dev, sim, steps=8):
    """Phase 38: the sweep (its window 512: an x-slab of the pile holds some 256 bodies) and
    the grid broad phases on phase 37's pile, ``steps`` steps each. Every step's pair list
    (pairs, their order, validity, overflow and the demand counters) must be exactly the CPU
    function's on the same bounds. The overflow flags are printed, not held: the sweep keeps
    a pair in the row of the body first along x, and the ground, first of all, meets more
    bodies than a row keeps (32), in both packages. Returns K1's launches over those
    steps."""
    from types import SimpleNamespace

    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.utils.vec import Vec3

    fn = tsim.broad_phase
    seen = []

    def record(lo, hi, bodies, config):
        out = fn(lo, hi, bodies, config)
        seen.append(([t.cpu() for t in (*lo, *hi)], [t.cpu() for t in (
            bodies.kind, bodies.awake, bodies.collision_group)], config, out))
        return out

    before = _kernel_launches()
    notes = []
    for method, over in (("sweep", dict(sweep_window=512)), ("grid", {})):
        sim.reconfigure(broadphase=method, **over)
        seen.clear()
        tsim.broad_phase = record
        t0 = time.perf_counter()
        try:
            sim.run(steps, DT)
            torch.cuda.synchronize()
        finally:
            tsim.broad_phase = fn
        elapsed = time.perf_counter() - t0
        same, counts, ovf = 0, [], False
        for bounds, (kind, awake, group), config, out in seen:
            want = fn(Vec3(*bounds[:3]), Vec3(*bounds[3:]),
                      SimpleNamespace(kind=kind, awake=awake, collision_group=group), config)
            same += all(torch.equal(getattr(out, f).cpu(), getattr(want, f))
                        for f in ("a", "b", "valid", "overflow", "demand"))
            counts.append(int(want.valid.sum()))
            ovf |= bool(want.overflow)
        notes.append(f"{method}: {same} of {len(seen)} steps' pair lists equal to the CPU's, "
                     f"{min(counts)}-{max(counts)} pairs a step, overflow {ovf}, "
                     f"{steps / elapsed:.2f} steps/s (the bounds copied out each step)")
        _require(len(seen) == steps and same == steps,
                 f"the {method} broad phase on the card differs from the CPU's")
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    print(f"[38 sweep and grid] phase 37's pile, {steps} steps each: " + "; ".join(notes)
          + f"; launches {launches}")
    _require(launches == dict(K1=2 * steps, K2=0, K3=0, K4=0), "K1 did not launch once a step")
    return launches["K1"]


def phase_batched(dev, n_bodies=512, steps=4):
    """Phase 39: ``BATCHED_WORLDS`` 512-body piles of seeds 0-7, their lowest layer on the
    ground (so that the steps solve contacts), stacked and stepped ``steps`` times by
    ``parallel.sharding.batched_step_fn`` (one world after another, as the JAX package's
    scan), each world bit-identical to a lone card ``Simulation`` of the same seed stepped
    as often (every leaf of the state). Returns K1's launches in the batched steps."""
    from bepuphysics2_tpu_torch.parallel.sharding import _stack, batched_step_fn
    from bepuphysics2_tpu_torch.simulation import _leaves

    sims = [build_pile(n_bodies, dev, seed=s, floor=0.5) for s in range(BATCHED_WORLDS)]
    states = _stack([s.state for s in sims])
    fn = batched_step_fn(sims[0].config, present_types=sims[0]._present_types())
    shapes = sims[0].shapes.device(dev)
    before = _kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        states, diags = fn(states, shapes, {}, DT)
    torch.cuda.synchronize()
    sps = steps / (time.perf_counter() - t0)
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    equal = 0
    for i, sim in enumerate(sims):
        sim.run(steps, DT)
        world = [x[i] for x in _leaves(states)]
        lone = list(_leaves(sim.state))
        equal += len(world) == len(lone) and all(torch.equal(a, b) for a, b in zip(world, lone))
    print(f"[39 batched worlds] {BATCHED_WORLDS} {n_bodies}-body piles (seeds 0-"
          f"{BATCHED_WORLDS - 1}), {steps} batched steps: {sps:.2f} batched steps/s "
          f"({sps * BATCHED_WORLDS:.2f} world steps/s); {equal} of {BATCHED_WORLDS} worlds "
          f"bit-identical to a lone card Simulation of the same seed; launches {launches}; "
          f"pairs per world {[int(p) for p in diags.pair_count]}, contacts "
          f"{[int(c) for c in diags.contact_count]}")
    _require(equal == BATCHED_WORLDS, "a batched world differs from its lone simulation")
    _require(bool((diags.contact_count > 0).all()), "a batched world solved no contact")
    _require(launches == dict(K1=BATCHED_WORLDS * steps, K2=0, K3=0, K4=0),
             "K1 did not launch once per world per step")
    return launches["K1"]


def sharded_pile(device):
    """Phase 40's scene: ``build_pile(1024)`` (bench.py's settings, sleep on) with its
    lowest layer on the ground, so that every step solves contacts, and ``SHARD_JOINTS``
    ball sockets, each between two z-neighbours of one of its first rows (handles
    1 + 11 j and 2 + 11 j, 1.2 m apart: the pile is 11 bodies deep)."""
    sim = build_pile(SHARD_BODIES, device, floor=0.5)
    for j in range(SHARD_JOINTS):
        sim.add_constraint("ball_socket", [1 + 11 * j, 2 + 11 * j],
                           local_offset_a=(0.0, 0.0, 0.6), local_offset_b=(0.0, 0.0, -0.6))
    return sim


def _sharded_run(dev):
    """``SHARD_STEPS`` steps of ``sharded_pile`` through ``sharded_step_fn`` on the default
    process group. Returns this rank's numbers and bodies."""
    import torch.distributed as dist

    from bepuphysics2_tpu_torch.parallel import comm
    from bepuphysics2_tpu_torch.parallel.sharding import make_mesh, shard_state, sharded_step_fn

    sim = sharded_pile(dev)
    state, shapes, banks = sim.state, sim.shapes.device(dev), sim._joint_banks()
    mesh = make_mesh()
    fn = sharded_step_fn(sim.config, mesh, sim._present_types())(state, shapes, banks)
    st = shard_state(state, mesh)
    contact_steps = torch.zeros((), dtype=torch.int32, device=dev)
    before = _kernel_launches()
    torch.cuda.synchronize()
    c0, t0 = comm.calls, time.perf_counter()
    for _ in range(SHARD_STEPS):
        st, diag = fn(st, shapes, banks, DT)
        contact_steps += diag.contact_count > 0
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    b = st.bodies
    return dict(
        bodies=torch.cat([torch.stack(list(getattr(b, f)))
                          for f in ("pos", "orn", "vel", "omega")]).cpu().numpy(),
        awake=b.awake.cpu().numpy(), sps=SHARD_STEPS / elapsed,
        collectives=(comm.calls - c0) / SHARD_STEPS, pairs=int(diag.pair_count),
        contacts=int(diag.contact_count), contact_steps=int(contact_steps),
        overflow=bool(diag.overflow),
        launches={k: v - before[k] for k, v in _kernel_launches().items()},
        backend=str(dist.get_backend()), world=dist.get_world_size())


def _shard_rank(rank, world, store_path, out_path, device_index, backend):
    """One rank of phase 40 in a process of its own: its rendezvous through a FileStore,
    ``_sharded_run`` on card ``device_index``, its result pickled to ``out_path``."""
    import datetime
    import pickle
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        torch.cuda.set_device(device_index)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            out = _sharded_run(torch.device("cuda", device_index))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001  (handed to the main process, which raises)
        out = dict(error=traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _start_shard_ranks(world, backend="gloo", one_card=True):
    """Starts ``world`` ranks of ``_shard_rank`` (on card 0, or one card each). Returns the
    handle ``_join_procs`` takes."""
    import multiprocessing as mp

    root = Path("build") / f"shard_{backend}_{world}_{time.time_ns()}"
    root.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    outs = [root / f"rank_{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_shard_rank, daemon=True, args=(
        r, world, str(root / "store"), str(outs[r]), 0 if one_card else r, backend))
        for r in range(world)]
    for p in procs:
        p.start()
    return dict(procs=procs, outs=outs)


def _join_procs(handle, label="phase 40's ranks"):
    """Waits for every process of ``handle`` (one deadline) and returns their results."""
    import pickle

    deadline = time.monotonic() + SHARD_TIMEOUT_S
    for p in handle["procs"]:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(handle["procs"]) if p.is_alive()]
    _stop_procs(handle)
    _require(not hung, f"{label} {hung} did not finish within {SHARD_TIMEOUT_S} s")
    results = []
    for r, path in enumerate(handle["outs"]):
        _require(path.exists(), f"{label} {r} ended without a result")
        with open(path, "rb") as f:
            res = pickle.load(f)
        _require("error" not in res, f"{label} {r} failed:\n{res.get('error')}")
        results.append(res)
    return results


def _stop_procs(handle):
    for p in handle["procs"]:
        if p.is_alive():
            p.terminate()
            p.join(10)


def _shard_note(res):
    return (f"{res['sps']:.2f} steps/s, {res['collectives']:g} collectives a step, "
            f"contacts on {res['contact_steps']} of {SHARD_STEPS} steps, last step's pairs "
            f"{res['pairs']} and contacts {res['contacts']}, overflow {res['overflow']}")


def phase_sharded(dev, name, smi, runs):
    """Phase 40: queue 1 item 23 on the card. ``sharded_pile`` (1,024 bodies, 8 ball
    sockets, sleep on), ``SHARD_STEPS`` steps of the constraint-sharded step on one gloo
    rank and on two gloo ranks sharing the card (``runs``: processes of their own,
    started before phase 37, stepping while phases 37-39 run on the same card; their
    steps/s are taken so). Gloo runs every collective of the path on the CUDA tensors it
    is given: ``all_gather_into_tensor`` (the coloring table, the warm start's and the
    Jacobi pass's rows) and ``all_reduce`` with SUM (each color's velocity deltas and the
    diagnostics), MIN (island labels) and MAX (woken labels, the overflow flag). The two
    ranks' bodies must be identical to each other and to the one rank's (the Jacobi and
    warm-start rows are summed in one global order, so the result does not depend on the
    world size; a difference of at most 1e-6 is allowed and printed). The masked solve
    reaches no kernel. Where the machine has two cards, two ranks on NCCL, one per card,
    are held the same way."""
    (one,), two = (_join_procs(r) for r in runs)
    held = [("2 gloo ranks on one card", two)]
    if torch.cuda.device_count() >= 2:
        held.append(("2 NCCL ranks, one per card", _join_procs(_start_shard_ranks(
            2, "nccl", one_card=False))))
    notes, worst = [], 0.0
    for label, res in held:
        diff = max(float(np.abs(r["bodies"] - one["bodies"]).max()) for r in res)
        same = all(np.array_equal(r["bodies"], one["bodies"])
                   and np.array_equal(r["awake"], one["awake"]) for r in res)
        worst = max(worst, diff)
        notes.append(f"{label} ({res[0]['backend']}): {_shard_note(res[0])}; "
                     + ("bit-identical to the one rank" if same
                        else f"max |d| from the one rank {diff:.3e}"))
        _require(all(r["launches"] == dict(K1=0, K2=0, K3=0, K4=0) for r in res),
                 "the masked sharded solve launched a kernel")
        _require(not res[0]["overflow"], "the sharded pile overflowed")
    print(f"[40 sharded] {SHARD_BODIES}-body pile, {SHARD_JOINTS} ball sockets, sleep on, "
          f"{SHARD_STEPS} steps of the constraint-sharded step on {name} ({smi}), while "
          f"phases 37-39 ran: one gloo rank ({one['backend']}): {_shard_note(one)}; "
          + "; ".join(notes))
    _require(worst <= 1e-6, f"the ranks' bodies part from the one rank's by {worst:.3e}")
    _require(one["contact_steps"] == SHARD_STEPS,
             f"the sharded pile solved contacts on {one['contact_steps']} of {SHARD_STEPS} "
             "steps only")


def slice14_phases(dev, name, smi):
    """Phases 37-40. Returns each new path's (kernel, launches)."""
    # Phase 40's runs, one rank and two, step in processes of their own meanwhile.
    runs = [_start_shard_ranks(1), _start_shard_ranks(2)]
    try:
        sim, k1_legacy = phase_legacy_pile(dev, name, smi)
        phase_determinism(dev, "37 determinism", " on the legacy path", steps=30, **LEGACY)
        phase_cpu_vs_card(dev, "37 cpu vs card", " on the legacy path", n_bodies=256,
                          **LEGACY)
        k3_tube = phase_legacy_tube(dev)
        k1_bp = phase_broadphases(dev, sim)
        del sim
        k1_batched = phase_batched(dev)
        phase_sharded(dev, name, smi, runs)
    finally:
        for r in runs:
            _stop_procs(r)
    return {"4k pile, legacy path (phase 37)": ("K1", k1_legacy),
            "4-ragdoll tube, legacy path (phase 37)": ("K3", k3_tube),
            "4k legacy pile, sweep and grid, 8 steps each (phase 38)": ("K1", k1_bp),
            "8 batched 512-body worlds (phase 39)": ("K1", k1_batched)}


def slice12_phases(dev, name, smi):
    """Phases 32-33, with K8 held on phase 33's sweeps. Returns each new path's (kernel,
    launches) and K8's row."""
    from bepuphysics2_tpu_torch.collision import sweeps

    cpu_side = _start_cpu_worker()  # phase 33's CPU side builds its pile meanwhile
    try:
        sim, k1, _ = phase_terrain_pile(dev, name, smi)
        before = sweeps.conservative_advance.launches
        k8_call = phase_queries(dev, sim, cpu_side)
        k8_launches = sweeps.conservative_advance.launches - before
    finally:
        if cpu_side[0].is_alive():
            cpu_side[0].terminate()
            cpu_side[0].join()
    del sim
    k8 = phase_kernel_k8(dev, k8_call, 2)
    del k8_call
    k8["paths"] = {"256 capsule sweeps, twice (phase 33)": 2,
                   "every query of phase 33": k8_launches}
    return {"4k mesh-terrain pile": ("K1", k1)}, k8


def slice11_phases(dev, name, smi):
    """Phases 29-30 (phase 31 steps in a process of its own: ``_start_vehicles``), then
    their replayed graphs cleared, as phase 33 clears its own. Returns each new path's
    (kernel, launches)."""
    from bepuphysics2_tpu_torch.utils import replay

    k1, _, _ = phase_five_shape_pile(dev, name, smi, timed=48)
    phase_five_shape_small(dev)
    replay.clear()
    return {"4k five-shape pile": ("K1", k1)}


def slice10_phases(dev, name, smi):
    """Phases 25-28. Returns each new path's (kernel, launches)."""
    paths = {"2,880 colosseum": phase_colosseum(dev, name, smi, 2880, "25 colosseum")}
    phase_determinism_colosseum(dev)
    paths["23,040 colosseum"] = phase_colosseum(dev, name, smi, 23040, "26 colosseum")
    paths["64x64 cloth"] = ("K3", phase_cloth(dev, name, smi))
    phase_cloth_small(dev)
    phase_joint_rigs(dev)
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    import bepuphysics2_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    _start_cpu_side()  # the CPU sides of phases 6-37, computed while the card runs
    try:
        return _phases(dev, name, smi, t_start)
    finally:
        _stop_cpu_side()


def _phases(dev, name, smi, t_start):
    """Phases 3-40 and the kernels line; the CPU sides come from ``_cpu_side_worker``."""
    # The main path runs first: phase 3 holds K1 on its last step's K1 call.
    k1_launches, k1_call = phase_main_path(dev, name, smi)
    k1 = phase_kernel(dev, k1_call)
    k1["launches"] = k1_launches
    phase_determinism(dev)
    phase_cpu_vs_card(dev)
    k2 = phase_kernel_win(dev)
    # The timed windows gate nothing, and they are cut to keep the whole run inside its
    # time limit: the two 32-ragdoll tubes time 16 steps and the ragdoll pile 32, the 16k
    # and five-shape piles 48 (bench.py: 96).
    k2["launches"] = phase_main_path_win(dev, name, smi, timed=48)
    win = dict(solver_backend="pallas_win", broadphase="grid2")
    phase_determinism(dev, "9 determinism", " on the windowed path (grid2, K2)", **win)
    phase_cpu_vs_card(dev, "10 cpu vs card", " on the windowed path", WIN_TOL, **win)
    k3_launches = phase_main_path_tube(dev, name, smi, timed=16)
    phase_determinism_tube(dev)
    phase_cpu_vs_card_tube(dev)
    # Phase 11 holds K3 on the last step's K3 calls of phase 15.
    k3 = phase_kernel_k3(dev, phase_tube_default_settings(dev, name, smi, timed=16))
    k3["launches"] = k3_launches
    # The main path runs first: phase 16's bank takes the store rows autosize gives it.
    pile_launches, pile_rows = phase_main_path_pile(dev, name, smi)
    k4 = phase_kernel_k4(dev, pile_rows)
    k4["launches"] = pile_launches
    phase_determinism_pile(dev)
    phase_cpu_vs_card_pile(dev)
    phase_compound_pile(dev)
    k5 = phase_probe_sweep(dev)
    k6, k7 = phase_probe_gather_scatter(dev)
    # Slice 9: the schedule and the callback off K1 and K2, through K3 and K4.
    k3["paths"] = {"32-ragdoll tube": k3["launches"],
                   "4k pile, schedule and callback": phase_schedule_pile(dev, name, smi)}
    sched = _schedule_overrides()
    phase_determinism(dev, "23 determinism", " with the schedule and the callback", **sched)
    phase_cpu_vs_card(dev, "23 cpu vs card", " with the schedule and the callback",
                      n_bodies=512, **sched)
    k4["paths"] = {"1,024-ragdoll pile": k4["launches"],
                   "16k pile, schedule": phase_schedule_pile_win(dev, name, smi)}
    phase_cpu_vs_card(dev, "24 cpu vs card", " on the windowed path with the schedule",
                      WIN_TOL, **_schedule_overrides(callback=False), **win)
    # Slice 10: the colosseum through K1 and K2, the cloth through K3, every joint type.
    paths = slice10_phases(dev, name, smi)
    # Slice 12 before slice 11: the mesh-terrain pile (K1), the queries on it and K8's hold
    # on their sweeps run first, so that phase 31's processes (the car and the tank, K3,
    # K8), which would share the card with K8's timed calls, start right after them and
    # step beside phases 29-30 and 34-40.
    new, k8 = slice12_phases(dev, name, smi)
    paths.update(new)
    vehicles = _start_vehicles(name, smi)
    try:
        # Slice 11: the five-shape pile over the generic narrow phase (K1).
        paths.update(slice11_phases(dev, name, smi))
        # Slice 12: 64 characters (K3).
        paths["64 characters"] = ("K3", phase_characters(dev, name, smi)[0])
        # Slice 13: CCD on the 4k pile (K1, K8); the utilities on phase 4's pile.
        paths["4k pile, 256 continuous spheres (phase 35)"] = (
            "K8", phase_ccd(dev, name, smi))
        phase_utilities(dev, _PILE.pop("4k"))
        # Slice 14: the legacy path (K1, K3), sweep and grid, batched worlds, the sharded
        # step.
        paths.update(slice14_phases(dev, name, smi))
        paths.update(_vehicle_paths(vehicles))
    finally:
        _stop_procs(vehicles)
    k1["paths"] = {"4k pile": k1["launches"]}
    k2["paths"] = {"16k pile": k2["launches"]}
    for path, (kernel, n) in paths.items():
        dict(K1=k1, K2=k2, K3=k3, K8=k8)[kernel]["paths"][path] = n
    # No single PyTorch call computes K1-K5 or K7 (ordered Gauss-Seidel walks; 36
    # dependent passes; a read-add-set whose last writer wins): their library_ms is null.
    for k in (k1, k2, k3, k4):
        k["library_ms"] = None
    rows = [("solve_substeps_contacts (K1)", K1_SOURCE, K1_REPLACES, k1),
            ("solve_substeps_contacts_win (K2)", K2_SOURCE, K2_REPLACES, k2),
            ("contact_sweep (K3)", K3_SOURCE, K3_REPLACES, k3),
            ("contact_sweep_win (K4)", K4_SOURCE, K4_REPLACES, k4),
            ("probe_sweep (K5)", K5_SOURCE, K5_REPLACES, k5),
            ("probe_gather (K6)", K6_SOURCE, K6_REPLACES, k6),
            ("probe_scatter (K7)", K7_SOURCE, K7_REPLACES, k7),
            ("conservative_advance (K8)", K8_SOURCE, K8_REPLACES, k8)]
    print(f"[done] 40 phases in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [dict(
        name=n, route="cuda", source=src, replaces=rep, launches=k["launches"],
        max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=k["library_ms"],
        kernel_ms=k.get("kernel_ms"), launches_by_path=k.get("paths"),
        **{key: k[key] for key in K8_EXTRA if key in k},
    ) for n, src, rep, k in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
