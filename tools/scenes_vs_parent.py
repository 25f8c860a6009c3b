"""Hold the port's existing card scenes to an earlier commit's: the same ``state_hash``, the
same kernel launches and the same number of CUDA kernels per step.

    python3 tools/scenes_vs_parent.py --parent <git archive of the earlier commit> \
        [--scenes 4k,16k,tube,colosseum,rigs] [--out build/scenes_vs_parent.json]

runs each scene once in the parent's tree and once in this one, each in a process of its
own (each imports its tree's ``chip_smoke.py`` and package), and prints one line per
scene and tree, then one JSON line with every number. The scenes, at ``chip_smoke.py``'s
settings: the 4,096-body pile after 129 steps (phase 4, K1), the 16,384-body pile after
bench.py's sequence to its autosize and 33 steps more (phase 8, grid2, K2), the 32-ragdoll
tube at the default settings after 49 steps (phase 15, K3), the 2,880-body colosseum
through ``run_colosseum`` (phase 25, K1) and the 30-rig battery after its 150 steps (phase
28, K3). Per scene: the state hash, each kernel's launches per step over the scene's last
4 steps, the host syncs per step over them (CUDA sync debug mode) and the CUDA kernels per
step over 2 more steps (``torch.profiler`` kernel events). Needs one card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SCENES = ("4k", "16k", "tube", "colosseum", "rigs")


def _scene(cs, name, dev):
    """The scene's simulation, stepped to where it is held."""
    if name == "4k":
        sim = cs.build_pile(4096, dev)
        sim.run(129, cs.DT)
    elif name == "16k":
        sim = cs.build_pile(16384, dev)
        sim.run(33 + max(31, int(6 * 16384 ** (1 / 3))), cs.DT)
        sim.autosize(cs.DT, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
        sim.run(33, cs.DT)
    elif name == "tube":
        sim = cs.tube_sim(32, dev, bench=False)
        sim.run(49, cs.DT)
    elif name == "colosseum":
        from bepuphysics2_tpu_torch.models import build_colosseum_sim, run_colosseum

        sim, _, handles, col_of = build_colosseum_sim(2880, device=dev)
        run_colosseum(sim, handles, col_of)
    else:
        from bepuphysics2_tpu_torch.models.joint_rigs import build_joint_rigs

        sim = build_joint_rigs(dev).sim
    return sim


def measure(root, names):
    """In this process, with ``root``'s tree first on the path: one dict per scene."""
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    dev = torch.device("cuda")
    out = {}
    for name in names:
        t0 = time.perf_counter()
        sim = _scene(cs, name, dev)
        torch.cuda.synchronize()
        before = cs._kernel_launches()
        _, syncs = cs._timed_syncs(sim, 4)
        launches = {k: (v - before[k]) / 4 for k, v in cs._kernel_launches().items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sim.run(2, cs.DT)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = dict(state_hash=f"{sim.state_hash():#018x}", launches_per_step=launches,
                         syncs_per_step=syncs, kernels_per_step=kernels / 2,
                         seconds=round(time.perf_counter() - t0, 1))
        print(f"{root.name} {name}: {json.dumps(out[name])}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--out", type=Path, default=Path("build/scenes_vs_parent.json"))
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    args = ap.parse_args()
    names = [s for s in args.scenes.split(",") if s]
    if args.root is not None:
        print("RESULT " + json.dumps(measure(args.root.resolve(), names)))
        return 0
    here = Path(__file__).resolve().parents[1]
    result = {}
    for tag, root in (("parent", args.parent.resolve()), ("change", here)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root",
                               str(root), "--scenes", ",".join(names)], cwd=root,
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        print("\n".join(ln for ln in proc.stdout.splitlines() if not ln.startswith("RESULT ")))
        if proc.returncode != 0 or not lines:
            print(f"{tag}: exit {proc.returncode}")
            return 1
        result[tag] = json.loads(lines[-1][len("RESULT "):])
    same = {n: {k: result["parent"][n][k] == result["change"][n][k]
                for k in ("state_hash", "launches_per_step", "kernels_per_step")}
            for n in names}
    print(json.dumps(dict(result, same=same)))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(result, same=same), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
