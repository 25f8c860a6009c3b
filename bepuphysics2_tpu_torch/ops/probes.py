"""K5, K6 and K7: the TPU design probes of ``experiments/`` as CUDA kernels.

Counterparts of the Pallas kernels in ``experiments/pallas_sweep_proto.py`` (v1),
``pallas_sweep_proto2.py`` (v2, modes A-D), ``pallas_sweep_proto3.py`` (v3),
``pallas_sweep_proto4.py`` (v4) and ``pallas_gather_probe.py`` (k1-k6):

- ``probe_sweep`` (K5, ``csrc/probe_sweep.cu``): passes of one Gauss-Seidel sweep over a
  body state of (NB, 8) floats held in the caller's layout. Each pass gathers the rows of
  its body list, runs the probes' fixed arithmetic (``math_block``) on them and adds the
  results back, duplicates summed. Modes C and D are v2's cost-isolating variants.
- ``probe_gather`` (K6, ``csrc/probe_gather.cu``): ``out = v[idx]`` (k1-k4, k6).
- ``probe_scatter`` (K7, ``csrc/probe_scatter.cu``): ``o = v; o[idx] += d`` as the TPU
  kernel k5 computes it, read-add-then-set, so with repeated indices the last row wins.

On a CUDA tensor each wrapper launches its hand-written kernel and counts the launch in
its ``.launches``; on a CPU tensor it runs the plain PyTorch version below, which the
kernel is held against. The TPU routing (bf16x3 one-hot matmuls, one-hot operands built
outside the kernel) is not carried over: the kernels read rows by index.

State layouts of the sweep, for NB bodies and a chunk width of ``lanes`` (L):
chunk-major (v1, v2; L = 128), shape (NB/L, 8L), component c of body b at
``[b // L, c·L + b % L]``; transposed (v3 with L = 128, v4 with L = 8), shape (8L, NB/L),
at ``[c·L + b % L, b // L]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MODES = {"A": 0, "B": 0, "C": 1, "D": 2}  # v2's modes; A is B (the JAX main runs A as B)
SMEM_LIMIT = 232448  # shared memory one block of an H100 may use, in bytes
SWEEP_WARPS = 32  # K5's block: 1,024 threads


def math_block(g):
    """The probes' fixed per-row arithmetic (``experiments/pallas_sweep_proto.py:24``)."""
    x = g * 1.0001 + 0.1
    for _ in range(6):
        x = x * 1.1 - 0.25 * x
    return x - g


# --- layouts ---------------------------------------------------------------------------

def to_state(v6, lanes, transposed):
    """(NB, 8) body rows -> the sweep's state layout (a contiguous copy)."""
    nb = v6.shape[0]
    chunks = v6.reshape(nb // lanes, lanes, 8)
    if transposed:
        out = chunks.permute(2, 1, 0).reshape(8 * lanes, nb // lanes)
    else:
        out = chunks.transpose(1, 2).reshape(nb // lanes, 8 * lanes)
    return out.clone(memory_format=torch.contiguous_format)


def to_rows(state, lanes, transposed):
    """The sweep's state layout -> (NB, 8) body rows (a contiguous copy)."""
    nb = state.numel() // 8
    if transposed:
        out = state.reshape(8, lanes, nb // lanes).permute(2, 1, 0).reshape(nb, 8)
    else:
        out = state.reshape(nb // lanes, 8, lanes).transpose(1, 2).reshape(nb, 8)
    return out.clone(memory_format=torch.contiguous_format)


# --- checks ----------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _route(name, dev):
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev.type}")
    return dev.type == "cuda"


def sweep_smem_bytes(nb, m):
    """K5's shared memory: the (NB, 8) state, a pass's (M, 8) deltas, two stages of a
    pass's body list, stable sort and distinct flag (with 3 unused words), and one
    partial sum per warp."""
    return nb * 32 + m * 32 + 2 * (2 * m + 4) * 4 + SWEEP_WARPS * 4


def _stable_order(idx):
    """Per row of ``idx``, its stable sort (int32): equal indices keep their order."""
    return torch.sort(idx, dim=-1, stable=True).indices.to(torch.int32).contiguous()


def distinct_passes(idx, order):
    """(passes,) int32: 1 where a pass's bodies are pairwise distinct, from its stable
    sort ``order`` (``_stable_order``): no two neighbours in sorted order are equal. K5
    adds such a pass's deltas from registers, one writer per body."""
    s = torch.gather(idx, 1, order.long())
    return (s[:, 1:] != s[:, :-1]).all(1).to(torch.int32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_ARGS = [_P] * 5 + [_I] * 6 + [_P]
_GATHER_ARGS = [_P] * 3 + [_I] * 3 + [_P]
_SCATTER_ARGS = [_P] * 4 + [_I] * 3 + [_P]


def _launch(name, fn_name, argtypes, *args):
    err = build.bind(name, fn_name, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_stream = build.raw_stream


# --- K5: the sweep ---------------------------------------------------------------------

def _sweep_pass_plain(V, rows, lanes, mode):
    """One pass on (NB, 8) rows ``V``, in place: gather, ``math_block``, add back."""
    if mode == "D":  # component 0 of bodies hi·L ... hi·L+7, not the row's own body
        g = V[(rows // lanes * lanes)[:, None] + torch.arange(8, device=V.device), 0]
    else:
        g = V[rows]
    d = math_block(g)
    if mode == "C":  # no scatter: the pass leaves 1e-30 of its deltas' sum in [0, 0]
        V[0, 0] += d.sum() * 1e-30
    else:
        V.index_add_(0, rows, d)


def _probe_sweep_plain(state, idx, lanes, transposed, mode):
    """Plain K5: the caller's layout to (NB, 8) rows, the passes in order with
    ``index_add_`` (repeated indices sum), and back."""
    V = to_rows(state, lanes, transposed)
    for rows in idx.long():
        _sweep_pass_plain(V, rows, lanes, mode)
    return to_state(V, lanes, transposed)


def probe_sweep(state, idx, *, lanes, transposed, mode="B", order=None, distinct=None):
    """Run every pass of ``idx`` ((passes, M) int32 body lists) over ``state`` (float32,
    the layout of ``lanes`` and ``transposed``). Returns the new state, same layout.

    ``mode`` is v2's: "A" and "B" the sweep, "C" gather and arithmetic only (each pass
    adds 1e-30 times the sum of its deltas to ``state[0, 0]``), "D" the sweep with each
    row gathering component 0 of bodies ``idx // L · L`` to ``+ 7``. ``order`` is the
    per-pass stable sort of ``idx`` and ``distinct`` its ``distinct_passes`` (int32, made
    here when omitted). Indices must lie in [0, NB): the plain version raises on others,
    the kernel leaves their rows out. Raises ``ValueError`` when K5's shared memory would
    exceed one block's."""
    dev = state.device
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    if idx.dim() != 2:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected (passes, M)")
    passes, m = idx.shape
    if state.dim() != 2 or state.shape[0 if transposed else 1] != 8 * lanes:
        raise ValueError(f"state has shape {tuple(state.shape)}, not a layout of "
                         f"{lanes} lanes ({'transposed' if transposed else 'chunk-major'})")
    nb = state.numel() // 8
    _check("state", state, (8 * lanes, nb // lanes) if transposed else (nb // lanes, 8 * lanes),
           torch.float32, dev)
    _check("idx", idx, (passes, m), torch.int32, dev)
    if order is not None:
        _check("order", order, (passes, m), torch.int32, dev)
    if distinct is not None:
        _check("distinct", distinct, (passes,), torch.int32, dev)
    if mode == "D" and lanes < 8:
        raise ValueError("mode D gathers 8 lanes of a chunk: it needs lanes >= 8")
    smem = sweep_smem_bytes(nb, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K5 holds the state in shared memory: {nb} bodies and {m} rows "
                         f"need {smem} bytes, over one block's {SMEM_LIMIT}")
    if not _route("probe_sweep", dev):
        return _probe_sweep_plain(state, idx, lanes, transposed, mode)
    out = torch.empty_like(state)
    if order is None:
        order = _stable_order(idx)
    if distinct is None:
        distinct = distinct_passes(idx, order)
    _launch("probe_sweep", "probe_sweep_launch", _SWEEP_ARGS, state.data_ptr(), out.data_ptr(),
            idx.data_ptr(), order.data_ptr(), distinct.data_ptr(), nb, m, passes, lanes,
            int(transposed), MODES[mode], _stream(dev))
    probe_sweep.launches += 1
    return out


probe_sweep.launches = 0


# --- K6: the gather --------------------------------------------------------------------

def _probe_gather_plain(v, idx):
    return v[idx.long()]


def probe_gather(v, idx):
    """``v[idx]`` for ``v`` (NB, W) float32 and ``idx`` (M,) int32: (M, W). Indices must
    lie in [0, NB): the plain version raises on others, the kernel writes NaN rows.

    A call is a few microseconds of card time, so the host path is kept short: every
    check of the other wrappers in one expression of cheap tensor properties (the full
    ``_check`` runs only to name what failed), the entry point bound once, the raw
    stream handle."""
    if (v.is_cuda and idx.is_cuda and (dv := v.get_device()) == idx.get_device()
            and v.dtype is torch.float32 and idx.dtype is torch.int32 and v.dim() == 2
            and idx.dim() == 1 and v.is_contiguous() and idx.is_contiguous()):
        nb, w = v.shape
        m = idx.shape[0]
        out = v.new_empty(m, w)
        err = _gather_launch()(v.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, m, w,
                               torch._C._cuda_getCurrentRawStream(dv))
        if err:
            raise RuntimeError(f"probe_gather kernel launch failed: CUDA error {err}")
        probe_gather.launches += 1
        return out
    dev = v.device
    if v.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"v {tuple(v.shape)} and idx {tuple(idx.shape)}: expected (NB, W), (M,)")
    _check("v", v, v.shape, torch.float32, dev)
    _check("idx", idx, idx.shape, torch.int32, dev)
    _route("probe_gather", dev)
    return _probe_gather_plain(v, idx)


def _gather_launch():
    """K6's C entry point, bound at the first launch and kept in ``_GATHER``."""
    if not _GATHER:
        _GATHER.append(build.bind("probe_gather", "probe_gather_launch", _GATHER_ARGS))
    return _GATHER[0]


_GATHER = []
probe_gather.launches = 0


# --- K7: the last-writer scatter -------------------------------------------------------

def _probe_scatter_plain(v, idx, d):
    """``o[idx[j]] = v[idx[j]] + d[j]`` in j order: each target takes its last row; an
    index outside [0, NB) writes nothing."""
    nb = v.shape[0]
    rows = idx.long()
    last = torch.full((nb + 1,), -1, dtype=torch.long, device=v.device)
    last.scatter_reduce_(0, torch.where((rows >= 0) & (rows < nb), rows, nb),
                         torch.arange(rows.numel(), device=v.device), "amax")
    hit = torch.nonzero(last[:nb] >= 0).squeeze(1)
    out = v.clone()
    out[hit] = v[hit] + d[last[hit]]
    return out


def probe_scatter(v, idx, d):
    """``o = v; o[idx] += d`` as TPU kernel k5 computes it (read, add, then set), for
    ``v`` (NB, W) and ``d`` (M, W) float32 and ``idx`` (M,) int32: (NB, W). A target
    named by several rows takes ``v`` plus the last of their ``d`` rows; an index outside
    [0, NB) writes nothing. One launch of K7, no sort: its blocks own row ranges and find
    each row's last writer with an integer max.

    As K6's, the host path is short: the checks in one expression of cheap tensor
    properties (the full ``_check`` runs only to name what failed), the entry point bound
    once, the raw stream handle."""
    if (v.is_cuda and idx.is_cuda and d.is_cuda
            and (dv := v.get_device()) == idx.get_device() == d.get_device()
            and v.dtype is torch.float32 and d.dtype is torch.float32
            and idx.dtype is torch.int32 and v.dim() == 2 and idx.dim() == 1 and d.dim() == 2
            and d.shape[0] == idx.shape[0] and d.shape[1] == v.shape[1]
            and v.is_contiguous() and idx.is_contiguous() and d.is_contiguous()):
        (nb, w), m = v.shape, idx.shape[0]
        out = torch.empty_like(v)
        if out.numel() == 0:
            return out
        err = _scatter_launch()(v.data_ptr(), idx.data_ptr(), d.data_ptr(), out.data_ptr(), nb,
                                m, w, torch._C._cuda_getCurrentRawStream(dv))
        if err:
            raise RuntimeError(f"probe_scatter kernel launch failed: CUDA error {err}")
        probe_scatter.launches += 1
        return out
    dev = v.device
    if v.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"v {tuple(v.shape)} and idx {tuple(idx.shape)}: expected (NB, W), (M,)")
    (nb, w), m = v.shape, idx.shape[0]
    _check("v", v, (nb, w), torch.float32, dev)
    _check("idx", idx, (m,), torch.int32, dev)
    _check("d", d, (m, w), torch.float32, dev)
    if _route("probe_scatter", dev):
        raise ValueError("probe_scatter: v, idx and d must lie on one CUDA device")
    return _probe_scatter_plain(v, idx, d)


def _scatter_launch():
    """K7's C entry point, bound at the first launch and kept in ``_SCATTER``."""
    if not _SCATTER:
        _SCATTER.append(build.bind("probe_scatter", "probe_scatter_launch", _SCATTER_ARGS))
    return _SCATTER[0]


_SCATTER = []
probe_scatter.launches = 0
