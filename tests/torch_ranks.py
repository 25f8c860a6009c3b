"""Ranks of a ``torch.distributed`` gloo group on the CPU, for the port's sharded-step tests.

``run_ranks(world, jobs, tmp)`` (or ``start_ranks`` and later ``join_ranks``) saves
``jobs`` ({scenario: inputs}, port tensors, with ``torch.save``), starts ``world`` spawned
processes that meet through a ``FileStore`` in ``tmp`` (no TCP port), each running ``SCENARIOS[scenario](rank, world, inputs)`` for every
job in turn with one torch thread, and returns each rank's {scenario: result}. The joins
share a deadline: a rank that hangs fails the test instead of the suite. This module
imports torch and the port, never JAX, so the ranks start quickly.
"""
from __future__ import annotations

import datetime
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import torch

RANK_TIMEOUT_S = 240


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return type(tree)(*(_to_numpy(v) for v in tree))


def _sharded(rank, world, inputs):
    """``frames`` sharded steps of one world: this rank's cache and joint impulses, the
    last diagnostics, the bodies after each frame."""
    from bepuphysics2_tpu_torch.parallel import comm
    from bepuphysics2_tpu_torch.parallel.sharding import (
        make_mesh, shard_state, sharded_step_fn,
    )

    mesh = make_mesh()
    cfg, shapes, banks = inputs["config"], inputs["shapes"], inputs["banks"]
    fn = sharded_step_fn(cfg, mesh, present_types=inputs["present"])(
        inputs["state"], shapes, banks)
    st = shard_state(inputs["state"], mesh)
    bodies, calls0 = [], comm.calls
    for _ in range(inputs["frames"]):
        st, diag = fn(st, shapes, banks, inputs["dt"])
        bodies.append(st.bodies)
    out = dict(bodies=bodies, cache=st.cache, joint_impulses=st.joint_impulses, diag=diag,
               collectives=comm.calls - calls0)
    bad = inputs.get("bad_config")
    if bad is not None:
        try:
            sharded_step_fn(bad, mesh)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
    return out


def _batched(rank, world, inputs):
    """This rank's share of a batch of worlds, one batched step."""
    from bepuphysics2_tpu_torch.parallel.sharding import batched_step_fn, make_mesh

    mesh = make_mesh()
    states = inputs["states"]
    n = states.bodies.pos.x.shape[0] // world
    share = type(states)(*(None if t is None else _slice(t, rank * n, (rank + 1) * n)
                           for t in states))
    fn = batched_step_fn(inputs["config"], mesh, present_types=inputs["present"])
    new, diags = fn(share, inputs["shapes"], inputs["banks"], inputs["dt"])
    return dict(states=new, diags=diags)


def _slice(tree, a, b):
    if torch.is_tensor(tree):
        return tree[a:b]
    if isinstance(tree, dict):
        return {k: _slice(v, a, b) for k, v in tree.items()}
    return type(tree)(*(_slice(v, a, b) for v in tree))


SCENARIOS = dict(sharded=_sharded, batched=_batched)


def _rank_main(rank, world, store_path, in_path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            jobs = torch.load(in_path, weights_only=False)
            result = {name: _to_numpy(SCENARIOS[name.split(":")[0]](rank, world, inputs))
                      for name, inputs in jobs.items()}
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001  (handed to the parent, which fails the test)
        result = dict(error=traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def start_ranks(world: int, jobs: dict, tmp) -> dict:
    """Starts ``world`` gloo ranks on ``jobs`` ({scenario: inputs}; a job's name is a
    scenario of ``SCENARIOS``, optionally followed by ``:`` and a label) and returns the
    handle ``join_ranks`` takes, so that the caller can work meanwhile."""
    tmp = Path(tmp)
    in_path = tmp / "rank_inputs.pt"
    torch.save(jobs, in_path)
    store = tmp / "rank_store"
    outs = [tmp / f"rank_{r}.pkl" for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(store), str(in_path),
                                                  str(outs[r])), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return dict(procs=procs, outs=outs, deadline=time.monotonic() + RANK_TIMEOUT_S)


def join_ranks(handle) -> list:
    """Each rank's {scenario: result (numpy leaves)}; a rank that has not finished by the
    deadline fails the caller."""
    procs = handle["procs"]
    for p in procs:
        p.join(max(0.0, handle["deadline"] - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish within {RANK_TIMEOUT_S} s"
    results = []
    for r, path in enumerate(handle["outs"]):
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r} failed:\n{res['error']}"
        results.append(res)
    return results


def run_ranks(world: int, jobs: dict, tmp) -> list:
    """``join_ranks(start_ranks(world, jobs, tmp))``."""
    return join_ranks(start_ranks(world, jobs, tmp))
