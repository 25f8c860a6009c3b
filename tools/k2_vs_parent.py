"""K1, K2 or K4 against an earlier version of its own source, on one CUDA card: both run
the kernel's input of ``chip_smoke.py`` (K1: phase 3's, the 4,096-body pile's own K1 call,
which this script takes from the pile; K2: phase 7's bank; K4: phase 16's), and the
script prints whether their results are equal bit for bit (int32 views; else the largest
difference per output), then each one's CUDA-event time per call, taken in turns
(earlier, current, current, earlier), the kernel alone (its C entry point on the
arguments its wrapper makes) and through its wrapper, beside the card's name and power
limit. Then the current kernel with every live slice a wave of its own (block 0 walks
them all in order: the chain without waves). With ``--sass`` it
also counts the current kernel's global loads in its SASS (``cuobjdump -sass``), and
among them the ones through the non-coherent read-only path (``LDG.E.CONSTANT``), which a
kernel that reads what other SMs wrote must not use.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k2_vs_parent.py --parent build/parent [--kernel k1|k2|k4] [--sass]
                                  [--breakdown]

The earlier source is ``<parent>/bepuphysics2_tpu_torch/csrc/<kernel>.cu`` with its
headers, built with the current nvcc flags; it may take the one-block launch's arguments
(before the wave table) or the current ones. ``--breakdown`` also times the current
kernel on the one-block table and on an empty table (for K1 and K2 at 0 and 2 velocity
iterations as well: the depth update, the body block and the barriers alone, then the warm
start, then the iterations), which splits a slice pass. Imports nothing of JAX.
"""
import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from bepuphysics2_tpu_torch.ops import build, sweep  # noqa: E402

NAMES = {"k1": "substeps_contacts", "k2": "substeps_contacts_win", "k4": "contact_sweep_win"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The one-block kernels' C arguments, before the wave table.
ONE_BLOCK_ARGS = {"k1": [_P] * 10 + [_I] * 6 + [_F] * 7 + [_P],
                  "k2": sweep._K2_ARGS[:10] + sweep._K2_ARGS[11:],
                  "k4": [_P] * 9 + [_I] * 3 + [_F, _P]}
CURRENT_ARGS = {"k1": sweep._K1_ARGS, "k2": sweep._K2_ARGS, "k4": sweep._K4_ARGS}


def _earlier_launch(parent, kernel):
    """The earlier kernel's C entry point, built from ``parent`` into build/parent_<k>/,
    and whether it takes the wave table."""
    name = NAMES[kernel]
    src_dir = os.path.join(parent, "bepuphysics2_tpu_torch", "csrc")
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        takes_waves = "const int* waves" in f.read()
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), f"parent_{kernel}")
    os.makedirs(out_dir, exist_ok=True)
    for header in os.listdir(src_dir):  # the parent's headers beside its source
        if header.endswith(".cuh") or header == f"{name}.cu":
            shutil.copy(os.path.join(src_dir, header), out_dir)
    lib = os.path.join(out_dir, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                    os.path.join(out_dir, f"{name}.cu")], check=True, capture_output=True,
                   text=True)
    fn = getattr(ctypes.CDLL(lib), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = CURRENT_ARGS[kernel] if takes_waves else ONE_BLOCK_ARGS[kernel]
    return fn, takes_waves


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


def _bank(kernel, dev, k4_rows):
    """(args, kw, waves, wrapper, passes per launch, label) of the kernel's bank."""
    if kernel == "k1":
        args, kw = chip_smoke.pile_k1_call(dev)
        kw = dict(kw)
        waves = kw.pop("waves")
        return args, kw, waves, sweep.solve_substeps_contacts, 2 * kw["n_substeps"], \
            "phase 3's input, the 4,096-body pile's own K1 call"
    if kernel == "k2":
        bank = sweep.synthetic_win_bank(16448, 140288, 16, seed=2, substeps=4, wide_frac=0.1,
                                        fill=0.66)
        kw = dict(sb=bank["sb"], n_substeps=4, n_iters=1, angular_mode=0,
                  gravity=(0.0, -10.0, 0.0))
        return sweep.win_bank_args(bank, dev), kw, torch.from_numpy(bank["waves"]).to(dev), \
            sweep.solve_substeps_contacts_win, 8, "phase 7's bank"
    bank, args, kw = chip_smoke.k4_bank(k4_rows, dev)
    return args, kw, torch.from_numpy(bank["waves"]).to(dev), sweep.contact_sweep_win, 1, \
        f"phase 16's bank ({k4_rows} store rows)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--kernel", choices=sorted(NAMES), default="k2")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
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
    earlier, takes_waves = _earlier_launch(args.parent, kernel)
    bank_args, kw, waves, wrapper, passes, label = _bank(kernel, dev, args.k4_rows)
    run_earlier = {"k1": _run_earlier_k1, "k2": _run_earlier_k2, "k4": _run_earlier_k4}[kernel]
    before = lambda f=earlier: run_earlier(f, bank_args, kw, waves if takes_waves else None)
    runs = {"current": lambda: wrapper(*bank_args, **kw, waves=waves)}
    ref = before()
    for m, fn in runs.items():
        out = fn()
        diffs = [float((x - y).abs().max()) for x, y in zip(_flat(out), _flat(ref))]
        print(f"{kernel.upper()} ({m}) vs earlier on {label}: bit-identical {_same(out, ref)}; "
              f"max |diff| per output {diffs}")

    def bare_earlier():
        out = {}

        def spy(*a):
            err = earlier(*a)
            out["ms"] = chip_smoke._time_ms(lambda: earlier(*a), args.reps)
            return err

        before(spy)
        return out["ms"]

    # The kernels alone (their C entry points on the arguments their wrappers make), then
    # through the wrappers, each in turns.
    turn = ["earlier", *runs, *reversed(list(runs)), "earlier"]
    bare = {k: [] for k in ["earlier", *runs]}
    wrapped = {k: [] for k in ["earlier", *runs]}
    for k in turn:
        bare[k].append(bare_earlier() if k == "earlier"
                       else chip_smoke._bare_ms(name, runs[k], args.reps))
    for k in turn:
        wrapped[k].append(chip_smoke._time_ms(before if k == "earlier" else runs[k], args.reps))
    n_slices = (waves.shape[0] - 2) // 2
    n, color, tail, barriers = sweep.wave_shape(waves)
    grid = sweep.wave_grid(name, kw["sb"], n_slices)
    fmt = lambda t: ", ".join(f"{k} {[round(x, 4) for x in v]}" for k, v in t.items())
    print(f"ms per call over {args.reps} calls, in turns: the kernel alone {fmt(bare)}; through "
          f"the wrapper {fmt(wrapped)}; grid {grid} blocks; per pass {n} waves: {len(color)} "
          f"color waves of {min(color, default=0)}-{max(color, default=0)} slices, {tail} tail "
          f"slices, {barriers} grid barriers")
    serial = _serial(waves)
    n_live = sum(len(w) for w in sweep.wave_lists(waves))
    one = lambda: wrapper(*bank_args, **kw, waves=serial)
    ms = chip_smoke._bare_ms(name, one, args.reps)
    per = lambda t: t * 1e3 / (passes * n_live)
    print(f"every slice a wave of its own: bit-identical {_same(one(), ref)}; {ms:.3f} ms per "
          f"call (the kernel alone), {per(ms):.3f} us per slice pass ({n_live} live slices, "
          f"{passes} passes); earlier {per(sum(bare['earlier']) / 2):.3f} us per slice pass")
    if args.breakdown:
        empty = torch.zeros_like(serial)  # no waves
        t = {"none": chip_smoke._bare_ms(name, lambda: wrapper(*bank_args, **kw, waves=empty),
                                         args.reps)}
        if kernel == "k4":
            print(f"empty table {t['none']:.3f} ms (launch, plan, barriers); one-block table "
                  f"{ms:.3f} ms: {(ms - t['none']) * 1e3 / n_live:.3f} us per slice pass")
        else:
            for lab, iters in (("warm", 0), ("warm+2", 2)):
                t[lab] = chip_smoke._bare_ms(
                    name, lambda: wrapper(*bank_args, **dict(kw, n_iters=iters), waves=serial),
                    args.reps)
            subs = kw["n_substeps"]
            print(f"one-block table: no slices {t['none']:.3f} ms (depth update, body block, "
                  f"barriers), warm start only {t['warm']:.3f} ms, warm start + 2 iterations "
                  f"{t['warm+2']:.3f} ms: "
                  f"{(t['warm'] - t['none']) * 1e3 / (subs * n_live):.3f} us per warm-start "
                  f"slice pass, {(t['warm+2'] - t['warm']) * 1e3 / (subs * 2 * n_live):.3f} us "
                  f"per iteration slice pass")
    if args.sass:
        n_ldg, const = _sass_loads(name)
        print(f"SASS of the current {kernel.upper()}: {n_ldg} global loads (LDG), {const} of "
              f"them LDG.E.CONSTANT")
    return 0


if __name__ == "__main__":
    sys.exit(main())
