"""K2 against an earlier version of its own source, on one CUDA card: both run the same
synthetic bank of ``chip_smoke.py`` phase 7 (16,448 bodies, 140,288 rows, 16 colors, 4
substeps, 1 iteration), and the script prints whether their results are equal bit for
bit (else the largest difference per output), then each one's CUDA-event time per call,
taken in turns (earlier, current, current, earlier), beside the card's name and power
limit, and the current K2's time with every live slice a wave of its own (block 0
walks them all in order: the chain without waves). With ``--sass`` it also counts the current K2's global loads in its SASS
(``cuobjdump -sass``), and among them the ones through the non-coherent read-only path
(``LDG.E.CONSTANT``), which a kernel that reads what other SMs wrote must not use.

    git archive <commit> | tar -x -C build/parent
    python3 tools/k2_vs_parent.py --parent build/parent [--sass]

The earlier source is ``<parent>/bepuphysics2_tpu_torch/csrc/substeps_contacts_win.cu``
with its headers, built with the current nvcc flags; it may take the one-block launch's
arguments (before the wave table) or the current ones. ``--breakdown`` also times the
current K2 on the one-block table at 0 and 2 velocity iterations and on an empty table
(the depth update, the body block and the barriers alone), which splits a slice pass
into warm start and iteration. Imports nothing of JAX.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from bepuphysics2_tpu_torch.ops import build, sweep  # noqa: E402

NAME = "substeps_contacts_win"


def _earlier_launch(parent):
    """The earlier K2's C entry point, built from ``parent`` into build/parent_k2/, and
    whether it takes the wave table."""
    src = os.path.join(parent, "bepuphysics2_tpu_torch", "csrc", f"{NAME}.cu")
    with open(src) as f:
        takes_waves = "const int* waves" in f.read()
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), "parent_k2")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{NAME}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib).substeps_contacts_win_launch
    fn.restype = ctypes.c_int
    fn.argtypes = sweep._K2_ARGS if takes_waves else sweep._K2_ARGS[:10] + sweep._K2_ARGS[11:]
    return fn, takes_waves


def _run_earlier(fn, args, kw, waves=None):
    """The earlier K2's launch, as its wrapper made it (``_launch_win_kernel``), with the
    wave table when it takes one."""
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


def _sass_loads():
    """(global loads, of them LDG.E.CONSTANT) in the current K2's SASS."""
    lib = next(build.BUILD_DIR.glob(f"{NAME}-{build.source_key(NAME)}.so"))
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    ldg = [ln for ln in sass.splitlines() if re.search(r"\bLDG\.", ln)]  # not LDGSTS (cp.async)
    return len(ldg), sum("CONSTANT" in ln for ln in ldg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_vs_parent: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(chip_smoke._nvidia_smi())
    build.load(NAME)
    earlier, takes_waves = _earlier_launch(args.parent)
    bank = sweep.synthetic_win_bank(16448, 140288, 16, seed=2, substeps=4, wide_frac=0.1,
                                    fill=0.66)
    bank_args = sweep.win_bank_args(bank, dev)
    waves = torch.from_numpy(bank["waves"]).to(dev)
    kw = dict(sb=bank["sb"], n_substeps=4, n_iters=1, angular_mode=0, gravity=(0.0, -10.0, 0.0))
    current = lambda: sweep.solve_substeps_contacts_win(*bank_args, **kw, waves=waves)
    before = lambda: _run_earlier(earlier, bank_args, kw, waves if takes_waves else None)
    flat = lambda out: [out[0], torch.stack(list(out[1])), torch.stack(list(out[2])), out[3]]
    a, b = flat(current()), flat(before())
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    diffs = [float((x - y).abs().max()) for x, y in zip(a, b)]
    print(f"current K2 vs earlier on phase 7's bank: bit-identical {same}; max |diff| per "
          f"output (v6, pos, orn, imp) {diffs}")
    times = {"earlier": [], "current": []}
    for label in ("earlier", "current", "current", "earlier"):
        times[label].append(chip_smoke._time_ms(current if label == "current" else before,
                                                args.reps))
    print(f"ms per call over {args.reps} calls, in turns: earlier {times['earlier']}, "
          f"current {times['current']}; grid {sweep.k2_grid(bank['sb'], bank['wseg'].shape[0])} "
          f"blocks")
    n_slices = bank["wseg"].shape[0]
    live = torch.nonzero(torch.from_numpy(bank["wseg"][:, 0] >= 0)).flatten().int()
    n_live = live.numel()
    serial = torch.cat([torch.tensor([n_live], dtype=torch.int32),
                        torch.arange(n_live + 1, dtype=torch.int32),
                        torch.full((n_slices - n_live,), n_live, dtype=torch.int32), live,
                        torch.full((n_slices - n_live,), -1, dtype=torch.int32)]).to(dev)
    one_block = lambda: sweep.solve_substeps_contacts_win(*bank_args, **kw, waves=serial)
    same = all(torch.equal(x, y) for x, y in zip(flat(one_block()), a))
    ms = chip_smoke._time_ms(one_block, args.reps)
    print(f"every slice a wave of its own: bit-identical {same}; {ms:.3f} ms per call, "
          f"{ms * 1e3 / (4 * 2 * n_live):.3f} us per slice pass ({n_live} live slices)")
    if args.breakdown:
        empty = torch.zeros_like(serial)  # no waves
        t = {}
        for label, table, iters in (("none", empty, 1), ("warm", serial, 0),
                                    ("warm+2", serial, 2)):
            run = lambda: sweep.solve_substeps_contacts_win(*bank_args, **dict(kw, n_iters=iters),
                                                            waves=table)
            t[label] = chip_smoke._time_ms(run, args.reps)
        warm = (t["warm"] - t["none"]) * 1e3 / (4 * n_live)
        it = (t["warm+2"] - t["warm"]) * 1e3 / (4 * 2 * n_live)
        print(f"one-block table: no slices {t['none']:.3f} ms (depth update, body block, "
              f"barriers), warm start only {t['warm']:.3f} ms, warm start + 2 iterations "
              f"{t['warm+2']:.3f} ms: {warm:.3f} us per warm-start slice pass, {it:.3f} us "
              f"per iteration slice pass")
    if args.sass:
        n, const = _sass_loads()
        print(f"SASS of the current K2: {n} global loads (LDG), {const} of them LDG.E.CONSTANT")
    return 0


if __name__ == "__main__":
    sys.exit(main())
