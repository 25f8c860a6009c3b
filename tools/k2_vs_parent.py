"""K1, K2, K3, K4, K5 or K7 against an earlier version of its own source, on one CUDA card:
both run the kernel's inputs of ``chip_smoke.py`` (K1: phase 3's, the 4,096-body pile's own
K1 call, which this script takes from the pile; K2: phase 7's bank; K3: phase 11's bank
and the 32-ragdoll tube's own K3 calls of one step, which this script takes from the tube;
K4: phase 16's bank; K5: every variant of the sweep prototypes' main, and v1 on passes
that repeat bodies; K7: the gather probe's main call and ``gather_probe.scatter_cases``),
and the script prints whether their results are equal bit for bit
(int32 views; else the largest difference per output), then each one's CUDA-event time
per call, taken in turns (earlier, current, current, earlier), the kernel alone (its C
entry point on the arguments its wrapper makes) and through its wrapper, beside the card's
name and power limit. For the cooperative kernels (K1-K4), then the current kernel with
every live slice a wave of its own (block 0 walks them all in order: the chain without
waves). With ``--sass`` it also counts the current kernel's global loads in its SASS
(``cuobjdump -sass``), and among them the ones through the non-coherent read-only path
(``LDG.E.CONSTANT``), which a kernel that reads what other SMs wrote must not use.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k2_vs_parent.py --parent build/parent [--kernel k1|k2|k3|k4|k5|k7] [--sass]
                                  [--breakdown] [--other-deal]

The earlier source is ``<parent>/bepuphysics2_tpu_torch/csrc/<kernel>.cu`` with its
headers, built with the current nvcc flags; it may take the one-block launch's arguments
(before the wave table, or K5's before its distinct flags) or the current ones.
``--breakdown`` splits a pass: for K1 and K2 the current kernel on the one-block table and
on an empty table, at 0 and 2 velocity iterations as well (the depth update, the body
block and the barriers alone, then the warm start, then the iterations); for K3 and K4 on
an empty table; for K5, both the earlier and the current kernel on v1's inputs with an
empty pass list, passes that only load their indices, passes without the math and passes
without the scatter (the earlier source with those lines changed; the current built with
``K5_PARTS``). ``--other-deal`` (K3) also times the current source with the other deal of
a color wave (its rows over the grid, or its slices to the blocks: ``DEAL_ROWS``). For K7
the earlier kernel is run as its wrapper ran it, with its own stable sort of the indices
(through the wrapper: sort and launch; alone: the launch on a sort made beforehand), and
the current kernel's grid of an empty kernel, launched through the same binding, gives the
launch floor. Imports nothing of JAX.
"""
import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from bepuphysics2_tpu_torch.experiments import gather_probe, sweep_proto  # noqa: E402
from bepuphysics2_tpu_torch.ops import build, probes, sweep  # noqa: E402

NAMES = {"k1": "substeps_contacts", "k2": "substeps_contacts_win", "k3": "contact_sweep",
         "k4": "contact_sweep_win", "k5": "probe_sweep", "k7": "probe_scatter"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The one-block kernels' C arguments, before the wave table (K5: before its flags).
ONE_BLOCK_ARGS = {"k1": [_P] * 10 + [_I] * 6 + [_F] * 7 + [_P],
                  "k2": sweep._K2_ARGS[:10] + sweep._K2_ARGS[11:],
                  "k3": [_P] * 7 + [_I] * 3 + [_F, _P],
                  "k4": [_P] * 9 + [_I] * 3 + [_F, _P],
                  "k5": [_P] * 4 + [_I] * 6 + [_P],
                  "k7": [_P] * 5 + [_I] * 3 + [_P]}
CURRENT_ARGS = {"k1": sweep._K1_ARGS, "k2": sweep._K2_ARGS, "k3": sweep._K3_ARGS,
                "k4": sweep._K4_ARGS, "k5": probes._SWEEP_ARGS, "k7": probes._SCATTER_ARGS}
# What marks the current signature in a source.
CURRENT_MARK = {"k5": "const int* distinct", "k7": "probe_scatter_empty_launch"}
# The earlier K5 with parts of each pass left out (--breakdown): its source's lines changed.
K5_EARLIER_PARTS = {
    "no math": [("d[c] = math_block(g);", "d[c] = g;")],
    "no scatter": [("const int b = sidx[sord[q]];", "const int b = -1;")],
}


def _build_lib(src_dir, name, out_dir, subs=()):
    """``<src_dir>/<name>.cu`` with its headers, each (old, new) of ``subs`` replaced once,
    built with the current nvcc flags into ``out_dir``. Returns the ctypes library."""
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, f), out_dir)
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        text = f.read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu holds {text.count(old)} copies of {old!r}")
        text = text.replace(old, new)
    with open(os.path.join(out_dir, f"{name}.cu"), "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                    os.path.join(out_dir, f"{name}.cu")], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(lib)


def _entry(lib, name, argtypes):
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _earlier_launch(parent, kernel, tag="", subs=()):
    """The earlier kernel's C entry point, built from ``parent`` into build/parent_<k><tag>/,
    and whether it takes the current arguments."""
    name = NAMES[kernel]
    src_dir = os.path.join(parent, "bepuphysics2_tpu_torch", "csrc")
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        current = CURRENT_MARK.get(kernel, "const int* waves") in f.read()
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), f"parent_{kernel}{tag}")
    lib = _build_lib(src_dir, name, out_dir, subs)
    argtypes = CURRENT_ARGS[kernel] if current else ONE_BLOCK_ARGS[kernel]
    return _entry(lib, name, argtypes), current


def _run_earlier_k1(fn, args, kw, waves):
    """The earlier K1's launch, as its wrapper made it: the plain stable sort and no table
    (one block), or the current wrapper's arguments."""
    v6, pos, orn, im, lii, gm, imk, ps_t, imp_t, idx2, scale, h, inv_h, ls, asc = args
    sb, B = kw["sb"], ps_t.shape[1]
    n = B // sb
    bg, pose, aux = sweep._pack_bodies(v6, pos, orn, im, lii, gm, imk)
    imp = imp_t.clone()
    dep = torch.empty((4, B), dtype=torch.float32, device=v6.device)
    idx = idx2.view(n, 2 * sb)
    if waves is None:
        order = torch.sort(idx, dim=1, stable=True).indices.int().contiguous()
    else:
        order = sweep.writer_order(idx, sweep.row_valid(ps_t, sb)
                                   & ~sweep.body_still(im, lii)[idx.long()])
    slive = (ps_t[sweep.PS_VALID].view(n, sb) > 0.5).any(dim=1).int()
    table = [] if waves is None else [waves.data_ptr()]
    err = fn(bg.data_ptr(), pose.data_ptr(), aux.data_ptr(), ps_t.data_ptr(), imp.data_ptr(),
             dep.data_ptr(), idx2.data_ptr(), scale.data_ptr(), order.data_ptr(),
             slive.data_ptr(), *table, v6.shape[0], B, sb, kw["n_substeps"], kw["n_iters"],
             *sweep._step_consts(kw["angular_mode"], kw["gravity"], h, inv_h, ls, asc),
             build.raw_stream(v6.device))
    if err:
        raise RuntimeError(f"the earlier K1 failed to launch: CUDA error {err}")
    return (*sweep._unpack_bodies(bg, pose), imp)


def _run_earlier_k2(fn, args, kw, waves):
    (v6p, pos_p, orn_p, im, lii, gm, imk, ps_t, imp_t, whi2, wlo2, scale, wseg, h, inv_h,
     lin_scale, ang_scale) = args
    bg, pose, aux = sweep._pack_bodies(v6p, pos_p, orn_p, im, lii, gm, imk)
    imp = imp_t.clone()
    order = sweep.window_order(whi2, wlo2, wseg, kw["sb"])
    err = fn(bg.data_ptr(), pose.data_ptr(), aux.data_ptr(), ps_t.data_ptr(), imp.data_ptr(),
             whi2.data_ptr(), wlo2.data_ptr(), scale.data_ptr(), wseg.data_ptr(),
             order.data_ptr(), *([] if waves is None else [waves.data_ptr()]),
             v6p.shape[0], ps_t.shape[1], kw["sb"], kw["n_substeps"],
             kw["n_iters"], *sweep._step_consts(kw["angular_mode"], kw["gravity"], h, inv_h,
                                                lin_scale, ang_scale),
             build.raw_stream(v6p.device))
    if err:
        raise RuntimeError(f"the earlier K2 failed to launch: CUDA error {err}")
    return (*sweep._unpack_bodies(bg, pose), imp)


def _run_earlier_k3(fn, args, kw, waves):
    """The earlier K3's launch: the plain stable sort and the live slices (one block), or
    the current wrapper's arguments."""
    v6, inertia7, ps_t, imp_t, idx2, scale, inv_h = args
    sb, B = kw["sb"], ps_t.shape[1]
    n = B // sb
    bg = torch.zeros((v6.shape[0], 16), dtype=torch.float32, device=v6.device)
    bg[:, :6] = v6
    bg[:, 8:15] = inertia7
    imp = imp_t.clone()
    if waves is None:
        order = torch.sort(idx2.view(n, 2 * sb), dim=1, stable=True).indices.int().contiguous()
        last = (ps_t[sweep.PS_VALID].view(n, sb) > 0.5).any(dim=1).int()
    else:
        order = sweep.writer_order(idx2.view(n, 2 * sb), sweep.sweep_writes(ps_t, inertia7,
                                                                             idx2, sb))
        last = waves
    err = fn(bg.data_ptr(), ps_t.data_ptr(), imp.data_ptr(), idx2.data_ptr(), scale.data_ptr(),
             order.data_ptr(), last.data_ptr(), B, sb, kw["n_iters"], float(inv_h),
             build.raw_stream(v6.device))
    if err:
        raise RuntimeError(f"the earlier K3 failed to launch: CUDA error {err}")
    return [bg[:, :6].contiguous(), imp]


def _run_earlier_k4(fn, args, kw, waves):
    """The earlier K4's launch: 16-float velocity rows, the plain position sort and no
    table (one block), or the current wrapper's arguments."""
    v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg, inv_h = args
    sb = kw["sb"]
    imp = imp_t.clone()
    if waves is None:
        bg = torch.nn.functional.pad(v6p, (0, 10))
        order = sweep.window_order(whi2, wlo2, wseg, sb)
    else:
        bg = torch.nn.functional.pad(v6p, (0, 2))
        order = sweep.writer_order(sweep.window_positions(whi2, wlo2, wseg, sb),
                                   sweep.stream_writes(ps_t, it_t, sb))
    table = [] if waves is None else [waves.data_ptr()]
    err = fn(bg.data_ptr(), it_t.data_ptr(), ps_t.data_ptr(), imp.data_ptr(), whi2.data_ptr(),
             wlo2.data_ptr(), scale.data_ptr(), wseg.data_ptr(), order.data_ptr(), *table,
             ps_t.shape[1], sb, kw["n_iters"], float(inv_h),
             build.raw_stream(v6p.device))
    if err:
        raise RuntimeError(f"the earlier K4 failed to launch: CUDA error {err}")
    return [bg[:, :6].contiguous(), imp]


def _run_earlier_k5(fn, args, kw, current):
    """The earlier K5's launch: its wrapper's arguments, without the distinct flags where
    it takes none."""
    c_args, keep = chip_smoke.k5_c_args(*args, kw, current)
    err = fn(*c_args)
    if err:
        raise RuntimeError(f"the earlier K5 failed to launch: CUDA error {err}")
    return [keep[0]]


def _k7_c_args(v, idx, d, order=None):
    """K7's C arguments for (v, idx, d): the earlier one-block kernel's (with ``order``,
    the stable sort of idx) or the current grid's. Returns (args, out)."""
    out = torch.empty_like(v)
    (nb, w), m = v.shape, idx.shape[0]
    mid = [] if order is None else [order.data_ptr()]
    lead = [v.data_ptr(), idx.data_ptr(), *mid, d.data_ptr(), out.data_ptr()]
    return (*lead, nb, m, w, build.raw_stream(v.device)), out


def main_k7(parent, reps):
    """K7 against its earlier source: bit for bit on the gather probe's main call and
    ``gather_probe.scatter_cases``; then on main's call, in turns, the earlier kernel
    (alone on a sort made beforehand, and through its wrapper's path: its stable sort
    and the launch) against the current (alone, and through its wrapper), and the
    current grid of an empty kernel through the same binding (the launch floor)."""
    dev = torch.device("cuda")
    earlier, current = _earlier_launch(parent, "k7")
    if current:
        raise RuntimeError("the earlier K7 already takes the current arguments")
    now = build.bind("probe_scatter", "probe_scatter_launch", probes._SCATTER_ARGS)
    empty = build.bind("probe_scatter", "probe_scatter_empty_launch", probes._SCATTER_ARGS)
    sort = lambda idx: torch.sort(idx, stable=True).indices.to(torch.int32).contiguous()
    calls = [("main's call", *gather_probe.inputs(dev))] + gather_probe.scatter_cases(dev)
    for label, v, idx, d in calls:
        c_args, out = _k7_c_args(v, idx, d, sort(idx))
        if earlier(*c_args):
            raise RuntimeError("the earlier K7 failed to launch")
        got = probes.probe_scatter(v, idx, d)
        print(f"K7 vs earlier on {label} (NB {v.shape[0]}, M {idx.shape[0]}, W {v.shape[1]}): "
              f"bit-identical {_same([got], [out])}, repeat identical "
              f"{_same([got], [probes.probe_scatter(v, idx, d)])}")
    _, v, idx, d = calls[0]
    order = sort(idx)
    e_args, _ = _k7_c_args(v, idx, d, order)
    c_args, _ = _k7_c_args(v, idx, d)
    runs = {"earlier alone": lambda: earlier(*e_args),
            "earlier with its sort": lambda: earlier(*_k7_c_args(v, idx, d, sort(idx))[0]),
            "current alone": lambda: now(*c_args),
            "current through its wrapper": lambda: probes.probe_scatter(v, idx, d),
            "empty kernel, same grid and binding": lambda: empty(*c_args)}
    times = {k: [] for k in runs}
    for turn in ("earlier", "current", "current", "earlier"):
        for k, fn in runs.items():
            if k.startswith(turn) or (turn == "current" and k.startswith("empty")):
                times[k].append(round(chip_smoke._time_ms(fn, reps), 5))
    print(f"main's call, ms per call over {reps} calls, in turns (earlier, current, current, "
          f"earlier): " + "; ".join(f"{k} {v} (mean {np.mean(v):.5f})" for k, v in times.items()))
    return 0


def _sass_loads(name):
    """(global loads, of them LDG.E.CONSTANT) in the current kernel's SASS."""
    lib = next(build.BUILD_DIR.glob(f"{name}-{build.source_key(name)}.so"))
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    ldg = [ln for ln in sass.splitlines() if re.search(r"\bLDG\.", ln)]  # not LDGSTS (cp.async)
    return len(ldg), sum("CONSTANT" in ln for ln in ldg)


def _serial(waves):
    """The same live slices with every slice a wave of its own (block 0 walks them)."""
    n = (waves.shape[0] - 2) // 2
    live = torch.zeros(n, dtype=torch.bool, device=waves.device)
    live[[sl for w in sweep.wave_lists(waves) for sl in w]] = True
    return sweep.waves_by_key(torch.full((n,), -1, device=waves.device), live)


def _flat(out):
    out = list(out)
    if len(out) == 4:  # K1, K2: (v6, pos, orn, imp)
        out = [out[0], torch.stack(list(out[1])), torch.stack(list(out[2])), out[3]]
    return out


def _same(a, b):
    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(_flat(a), _flat(b)))


def _calls(kernel, dev, k4_rows):
    """(calls, wrapper, passes per launch, label): the kernel's inputs as a list of (label,
    args, kw, waves), waves None for K5, whose kw is its layout and mode."""
    if kernel == "k1":
        args, kw = chip_smoke.pile_k1_call(dev)
        kw = dict(kw)
        waves = kw.pop("waves")
        return [("pile", args, kw, waves)], sweep.solve_substeps_contacts, \
            2 * kw["n_substeps"], "phase 3's input, the 4,096-body pile's own K1 call"
    if kernel == "k2":
        bank = sweep.synthetic_win_bank(16448, 140288, 16, seed=2, substeps=4, wide_frac=0.1,
                                        fill=0.66)
        kw = dict(sb=bank["sb"], n_substeps=4, n_iters=1, angular_mode=0,
                  gravity=(0.0, -10.0, 0.0))
        return [("bank", sweep.win_bank_args(bank, dev), kw,
                 torch.from_numpy(bank["waves"]).to(dev))], \
            sweep.solve_substeps_contacts_win, 8, "phase 7's bank"
    if kernel == "k3":
        args, kw = chip_smoke.k3_bank(dev)
        kw = dict(kw)
        kw.pop("order")
        calls = [("bank", args, kw, kw.pop("waves"))]
        sim = chip_smoke.tube_sim(32, dev, bench=False)
        sim.run(chip_smoke.TUBE_K3_STEPS, chip_smoke.DT)
        tube, _, _ = chip_smoke._k3_steps(sim, 1)
        for i, (a, k) in enumerate(tube):
            a, k = chip_smoke._clone_call(a, k)
            k = dict(k)
            k.pop("order")
            calls.append((f"tube {i}", a, k, k.pop("waves")))
        return calls, sweep.contact_sweep, 1, \
            "phase 11's bank and the 32-ragdoll tube's own 8 K3 calls of one step"
    if kernel == "k4":
        bank, args, kw = chip_smoke.k4_bank(k4_rows, dev)
        return [("bank", args, kw, torch.from_numpy(bank["waves"]).to(dev))], \
            sweep.contact_sweep_win, 1, f"phase 16's bank ({k4_rows} store rows)"
    v6, idx = sweep_proto.inputs()
    v6d, idxd = sweep_proto.inputs_with_duplicates()
    calls = []
    for name, _, lanes, transposed, mode in sweep_proto.VARIANTS:
        state = probes.to_state(torch.from_numpy(v6), lanes, transposed).to(dev)
        calls.append((name, (state, torch.from_numpy(idx).to(dev)),
                      dict(lanes=lanes, transposed=transposed, mode=mode), None))
    state = probes.to_state(torch.from_numpy(v6d), 128, False).to(dev)
    calls.append(("v1 repeated bodies", (state, torch.from_numpy(idxd).to(dev)),
                  dict(lanes=128, transposed=False, mode="B"), None))
    return calls, probes.probe_sweep, sweep_proto.PASSES, \
        "the sweep prototypes' variants and v1 on repeated bodies"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--kernel", choices=sorted(NAMES), default="k2")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--other-deal", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--k4-rows", type=int, default=chip_smoke.K4_ROWS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_vs_parent: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernel, name = args.kernel, NAMES[args.kernel]
    print(chip_smoke._nvidia_smi())
    build.load(name)
    if kernel == "k7":
        return main_k7(args.parent, args.reps)
    earlier, current_args = _earlier_launch(args.parent, kernel)
    calls, wrapper, passes, label = _calls(kernel, dev, args.k4_rows)
    run_earlier = {"k1": _run_earlier_k1, "k2": _run_earlier_k2, "k3": _run_earlier_k3,
                   "k4": _run_earlier_k4}.get(kernel)

    def before(f, call):
        _, a, kw, waves = call
        if kernel == "k5":
            return _run_earlier_k5(f, a, kw, current_args)
        return run_earlier(f, a, kw, waves if current_args else None)

    def now(call):
        _, a, kw, waves = call
        return [wrapper(*a, **kw)] if kernel == "k5" else wrapper(*a, **kw, waves=waves)

    for call in calls:
        out, ref = now(call), before(earlier, call)
        diffs = [float((x - y).abs().max()) for x, y in zip(_flat(out), _flat(ref))]
        print(f"{kernel.upper()} vs earlier on {label}, {call[0]}: bit-identical "
              f"{_same(out, ref)}; max |diff| per output {diffs}")

    def bare_earlier(call, fn=earlier):
        out = {}

        def spy(*a):
            err = fn(*a)
            out["ms"] = chip_smoke._time_ms(lambda: fn(*a), args.reps)
            return err

        before(spy, call)
        return out["ms"]

    # The kernels alone (their C entry points on the arguments their wrappers make), then
    # through the wrappers, each in turns, summed over the calls (K5: v1 alone).
    timed = calls[:1] if kernel == "k5" else calls
    turn = ["earlier", "current", "current", "earlier"]
    bare = {k: [] for k in ("earlier", "current")}
    wrapped = {k: [] for k in ("earlier", "current")}
    for k in turn:
        bare[k].append(sum(bare_earlier(c) if k == "earlier"
                           else chip_smoke._bare_ms(name, lambda c=c: now(c), args.reps)
                           for c in timed))
    for k in turn:
        wrapped[k].append(sum(chip_smoke._time_ms(
            (lambda c=c: before(earlier, c)) if k == "earlier" else (lambda c=c: now(c)),
            args.reps) for c in timed))
    fmt = lambda t: ", ".join(f"{k} {[round(x, 4) for x in v]}" for k, v in t.items())
    print(f"ms per call over {args.reps} calls, in turns, summed over {len(timed)} call(s): "
          f"the kernel alone {fmt(bare)}; through the wrapper {fmt(wrapped)}")
    if kernel == "k5":
        per = lambda ms: ms * 1e3 / passes
        print(f"v1: {per(np.mean(bare['current'])):.3f} us per pass, earlier "
              f"{per(np.mean(bare['earlier'])):.3f}")
        if args.breakdown:
            state, idx = calls[0][1]
            # The earlier kernel's "indices only": every index outside the state (each
            # pass loads its indices, writes zero deltas and walks the sort, adding none).
            runs = {"earlier, empty pass list": (earlier, current_args, 0, idx),
                    "earlier, indices only": (earlier, current_args, None,
                                              torch.full_like(idx, -1))}
            for part, subs in K5_EARLIER_PARTS.items():
                fn = _earlier_launch(args.parent, kernel, "_" + part.replace(" ", "_"), subs)[0]
                runs[f"earlier, {part}"] = (fn, current_args, None, idx)
            runs["earlier, whole"] = (earlier, current_args, None, idx)
            runs.update({f"current, {k}": v for k, v in chip_smoke.k5_parts(idx).items()})
            split = chip_smoke.k5_breakdown(runs, state)
            base = {w: split[f"{w}, empty pass list"] for w in ("earlier", "current")}
            print("v1's pass split, the kernel alone: " + "; ".join(
                f"{lab} {ms:.4f} ms" + ("" if "empty" in lab else
                                        f" ({(ms - base[lab.split(',')[0]]) * 1e3 / passes:.3f}"
                                        f" us per pass over the empty list)")
                for lab, ms in split.items()))
    else:
        serial_ms, n_live_all = 0.0, 0
        for c in calls:
            _, a, kw, waves = c
            n_slices = (waves.shape[0] - 2) // 2
            n, color, tail, barriers = sweep.wave_shape(waves)
            grid = sweep.wave_grid(name, kw["sb"], n_slices)
            print(f"{c[0]}: grid {grid} blocks; per pass {n} waves: {len(color)} color waves of "
                  f"{min(color, default=0)}-{max(color, default=0)} slices, {tail} tail "
                  f"slices, {barriers} grid barriers")
            serial = _serial(waves)
            one = lambda: wrapper(*a, **kw, waves=serial)
            serial_ms += chip_smoke._bare_ms(name, one, args.reps)
            n_live_all += sum(len(w) for w in sweep.wave_lists(waves))
            if not _same(one(), before(earlier, c)):
                print(f"{c[0]}: every slice a wave of its own is NOT bit-identical")
        per = lambda t: t * 1e3 / (passes * n_live_all)
        print(f"every slice a wave of its own: {serial_ms:.3f} ms (the kernel alone, summed), "
              f"{per(serial_ms):.3f} us per slice pass ({n_live_all} live slices, {passes} "
              f"passes); earlier {per(sum(bare['earlier']) / 2):.3f} us per slice pass")
        if args.breakdown and kernel in ("k3", "k4"):
            _, a, kw, waves = calls[0]
            t = chip_smoke._bare_ms(name, lambda: wrapper(*a, **kw,
                                                          waves=torch.zeros_like(waves)),
                                    args.reps)
            print(f"{calls[0][0]}: empty table {t:.3f} ms (launch, plan, barriers)")
        elif args.breakdown:
            _, a, kw, waves = calls[0]
            serial = _serial(waves)
            n_live = sum(len(w) for w in sweep.wave_lists(waves))
            empty = torch.zeros_like(serial)  # no waves
            t = {"none": chip_smoke._bare_ms(name, lambda: wrapper(*a, **kw, waves=empty),
                                             args.reps)}
            for lab, iters in (("warm", 0), ("warm+2", 2)):
                t[lab] = chip_smoke._bare_ms(
                    name, lambda: wrapper(*a, **dict(kw, n_iters=iters), waves=serial),
                    args.reps)
            subs = kw["n_substeps"]
            print(f"one-block table: no slices {t['none']:.3f} ms (depth update, body block, "
                  f"barriers), warm start only {t['warm']:.3f} ms, warm start + 2 iterations "
                  f"{t['warm+2']:.3f} ms: "
                  f"{(t['warm'] - t['none']) * 1e3 / (subs * n_live):.3f} us per warm-start "
                  f"slice pass, {(t['warm+2'] - t['warm']) * 1e3 / (subs * 2 * n_live):.3f} us "
                  f"per iteration slice pass")
        if args.other_deal and kernel == "k3":
            with open(build.CSRC / f"{name}.cu") as f:
                rows = "constexpr bool DEAL_ROWS = true;" in f.read()
            flip = [(f"constexpr bool DEAL_ROWS = {str(rows).lower()};",
                     f"constexpr bool DEAL_ROWS = {str(not rows).lower()};")]
            other = _entry(_build_lib(str(build.CSRC), name, os.path.join(
                os.path.dirname(build.BUILD_DIR), "k3_other_deal"), flip), name, sweep._K3_ARGS)
            key = (name, f"{name}_launch")
            real = build._bound[key]
            c = calls[0]
            ref = now(c)
            times = {"current": [], "other": []}
            try:
                for which in ("other", "current", "current", "other"):
                    build._bound[key] = other if which == "other" else real
                    times[which].append(chip_smoke._bare_ms(name, lambda: now(c), args.reps))
                build._bound[key] = other
                got = now(c)
            finally:
                build._bound[key] = real
            deal = "slices to the blocks" if rows else "rows over the grid"
            print(f"{c[0]}, the other deal (a color wave's {deal}): "
                  f"bit-identical to the current {_same(got, ref)}; the kernel alone in turns: "
                  f"current {times['current']}, other {times['other']} ms")
    if args.sass:
        n_ldg, const = _sass_loads(name)
        print(f"SASS of the current {kernel.upper()}: {n_ldg} global loads (LDG), {const} of "
              f"them LDG.E.CONSTANT")
    return 0


if __name__ == "__main__":
    sys.exit(main())
