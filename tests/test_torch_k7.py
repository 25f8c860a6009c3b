"""Kernel K7 (``csrc/probe_scatter.cu``, the scatter probe k5 of
``experiments/pallas_gather_probe.py``) on the CPU: a model of its block decomposition
against the plain version, bit for bit.

K7 is one launch of a grid of blocks over row ranges: block k owns output rows [k·ROWS,
(k+1)·ROWS), its threads take the max of the row number j over every index naming one of
its rows (``atomicMax`` in shared memory, in whatever order the threads reach it), and
after one barrier each owned row is written once, ``v + d[winner]`` where a winner exists
and ``v`` otherwise. The model here does the same in torch, block by block, with the
atomics in a seeded shuffled order; it must equal ``_probe_scatter_plain`` (the last
writer by ``scatter_reduce_``'s amax) in every bit on the probe's inputs and on
``gather_probe.scatter_cases``: all rows naming one target, indices outside [0, NB), more
rows than targets, -0.0 rows. The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch.experiments import gather_probe
from bepuphysics2_tpu_torch.ops import build, probes

CASES = [("probe", *gather_probe.inputs())] + gather_probe.scatter_cases()


def _kernel_rows():
    """ROWS, the output rows one block of K7 owns, as its source sets it."""
    text = (build.CSRC / "probe_scatter.cu").read_text()
    return int(re.search(r"constexpr int ROWS = (\d+);", text).group(1))


def _k7_blocks(v, idx, d, rows, seed=0):
    """K7's block decomposition in torch (see the module docstring)."""
    nb = v.shape[0]
    ii = idx.numpy().astype(np.int64)
    rng = np.random.default_rng(seed)
    out = torch.empty_like(v)
    for r0 in range(0, nb, rows):
        n = min(rows, nb - r0)
        win = np.full(n, -1)
        for j in rng.permutation(np.nonzero((ii >= r0) & (ii < r0 + n))[0]):
            win[ii[j] - r0] = max(win[ii[j] - r0], j)
        w = torch.from_numpy(win)
        hit = w >= 0
        blk = v[r0:r0 + n].clone()
        blk[hit] = v[r0:r0 + n][hit] + d[w[hit]]
        out[r0:r0 + n] = blk
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("rows", ["kernel", 7])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_block_model_equals_plain_bit_for_bit(case, rows):
    """At the kernel's ROWS and at 7 (a ragged last block everywhere), with two orders of
    the atomics."""
    _, v, idx, d = next(c for c in CASES if c[0] == case)
    rows = _kernel_rows() if rows == "kernel" else rows
    want = probes._probe_scatter_plain(v, idx, d)
    for seed in (0, 1):
        assert torch.equal(_bits(_k7_blocks(v, idx, d, rows, seed)), _bits(want))


def test_cases_cover_the_edges():
    """The cases hold what their labels say: repeated targets in the probe's indices,
    indices outside [0, NB) that write nothing, M > NB, untouched -0.0 rows."""
    c = {label: (v, idx, d) for label, v, idx, d in CASES}
    v, idx, d = c["probe"]
    assert idx.numel() - torch.unique(idx).numel() > 0
    v, idx, d = c["out of range"]
    assert bool(((idx < 0) | (idx >= v.shape[0])).any())
    out = probes._probe_scatter_plain(v, idx, d)
    named = torch.zeros(v.shape[0], dtype=torch.bool)
    named[idx[(idx >= 0) & (idx < v.shape[0])].long()] = True
    assert torch.equal(_bits(out[~named]), _bits(v[~named]))
    v, idx, d = c["M > NB"]
    assert idx.numel() > v.shape[0]
    v, idx, d = c["-0.0 rows"]
    out = probes._probe_scatter_plain(v, idx, d)
    untouched = torch.ones(v.shape[0], dtype=torch.bool)
    untouched[idx.long()] = False
    assert bool(torch.signbit(out[untouched]).all())
    assert not bool(torch.signbit(out[~untouched]).any())
    _, idx, _ = c["one target"]
    assert torch.unique(idx).numel() == 1


def test_wrapper_takes_no_order_and_runs_plain_on_the_cpu():
    """The wrapper has no ``order=`` (K7 makes no sort); on CPU tensors it is the plain
    version and counts no launch."""
    v, idx, d = gather_probe.inputs()
    with pytest.raises(TypeError, match="order"):
        probes.probe_scatter(v, idx, d, order=torch.argsort(idx).int())
    before = probes.probe_scatter.launches
    assert torch.equal(probes.probe_scatter(v, idx, d), probes._probe_scatter_plain(v, idx, d))
    assert probes.probe_scatter.launches == before
