"""Where the port's GJK or MPR and the JAX package's part, iteration by iteration, on
``tests/test_torch_convex.py``'s pair records (seed 0, the same draw as that test).

    JAX_PLATFORMS=cpu python tools/gjk_parting.py [--fn gjk|mpr] [--family all] [--iters 24]

For k = 0 ... ``--iters`` it runs both packages' ``gjk_closest`` (``GJK_ITERS`` = k) or
``mpr_penetration`` (``MPR_ITERS`` = k) on every family at once and, for each pair in the
function's domain (GJK: separated, distance above 1e-3; MPR: penetrating) whose final
distance or depth differs by more than 1e-4, prints the difference after each k and the
iteration where the two part (the first k after which they differ by more than 1e-4); a
last line per family counts the pairs by that iteration. Imports both packages (a
reference tool); ~1 min per function on the CPU.
"""
import argparse
import collections
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

BOUND = 1e-4


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fn", choices=("gjk", "mpr"), default="gjk")
    ap.add_argument("--family", default="all")
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args()
    torch.set_num_threads(1)
    from bepuphysics2_tpu.collision import convex as jconvex
    from bepuphysics2_tpu.shapes import custom as jcustom

    from bepuphysics2_tpu_torch.collision import convex
    from bepuphysics2_tpu_torch.shapes import custom as tcustom

    import test_torch_convex as T

    tid = jcustom.register_custom_shape(T._jax_ellipsoid)
    tcustom.register_custom_shape(T._torch_ellipsoid, type_id=tid)
    scene = T.scene.__wrapped__(tid)
    rng = np.random.default_rng(0)
    per = {fam: T._ctx(scene, fam, T.N, rng) for fam in T.FAMILIES}  # the test's draw
    fams = list(T.FAMILIES) if args.family == "all" else [args.family]
    jfn, tfn, it = dict(gjk=(jconvex.gjk_closest, convex.gjk_closest, "GJK_ITERS"),
                        mpr=(jconvex.mpr_penetration, convex.mpr_penetration,
                             "MPR_ITERS"))[args.fn]
    out = {fam: [] for fam in fams}
    for k in range(args.iters + 1):
        setattr(jconvex, it, k)
        setattr(convex, it, k)
        jit = jax.jit(lambda a: jfn(T._jctx(scene, a)))
        for fam in fams:
            jargs, tctx, _ = per[fam]
            out[fam].append((np.asarray(jit(T._jargs(jargs))[0]), tfn(tctx)[0].numpy()))
    for fam in fams:
        wd, gd = out[fam][-1]
        domain = wd > 1e-3 if args.fn == "gjk" else wd > 0.0
        parted = np.nonzero((np.abs(wd - gd) > BOUND) & domain)[0]
        at = collections.Counter()
        for i in parted:
            gaps = [abs(float(w[i]) - float(g[i])) for w, g in out[fam]]
            k = next(j for j in range(len(gaps)) if all(x > BOUND for x in gaps[j:]))
            at[k] += 1
            print(f"{fam} {args.fn} pair {i}: parts at iteration {k}; |JAX - port| after "
                  f"0..{args.iters}: {' '.join(f'{x:.1e}' for x in gaps)}; final "
                  f"{wd[i]:.6f} / {gd[i]:.6f}")
        print(f"{fam} {args.fn}: {parted.size} of {int(domain.sum())} pairs in the domain "
              f"part; by parting iteration {dict(sorted(at.items()))}")


if __name__ == "__main__":
    main()
