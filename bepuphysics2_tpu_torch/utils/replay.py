"""CUDA graph replay of a fixed sequence of PyTorch operations.

The joint sweep of the general path runs every joint type on every pass, masked by the
row tag, and the generic narrow phase runs 24 GJK and 24 MPR iterations masked over every
pair record: thousands of small kernels, the same sequence on every call of a scene.
Issued one by one from Python, each costs a launch on the host clock; captured once into
a CUDA graph and replayed, the same kernels run on the same buffers, so the results keep
their bits and the host issues one launch for all of them.
"""
import collections

import torch

# Captured graphs by key, oldest first: (graph, input buffers, output buffers).
_GRAPHS = collections.OrderedDict()
_SEEN = set()  # keys called once, eagerly, before their capture
MAX_GRAPHS = 16
enabled = True  # off: every call runs eagerly (to hold a replay against its eager run)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a named tuple (Vec3, Quat, Manifold, ...)
        return type(tree)(*(_clone(t) for t in tree))
    return type(tree)(_clone(t) for t in tree)


def run(key, fn, inputs: dict):
    """``fn(inputs)``: tensors in tuples and named tuples. ``inputs`` is a dict of tensors
    and of lists and named tuples of tensors; ``key`` names everything else ``fn`` depends
    on (Python constants and functions). On the CPU, and on the first call of a key,
    ``fn`` runs as it is (that call also loads every kernel it launches). From the second
    call on a CUDA device it runs as a graph captured once per key and input layout: the
    inputs are copied into the graph's own buffers, the graph is replayed, and copies of
    its outputs are returned."""
    leaves = _leaves(inputs)
    if not enabled or leaves[0].device.type != "cuda":
        return fn(inputs)
    key = (key, tuple((tuple(x.shape), x.dtype, x.device) for x in leaves))
    entry = _GRAPHS.get(key)
    if entry is None:
        if key not in _SEEN:
            _SEEN.add(key)
            return fn(inputs)
        static = _clone(inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(static)
        entry = _GRAPHS[key] = (graph, _leaves(static), out)
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)[1][0].reset()
    else:
        _GRAPHS.move_to_end(key)
    graph, buffers, out = entry
    for b, x in zip(buffers, leaves):
        b.copy_(x)
    graph.replay()
    return _clone(out)


def clear():
    """Drops every captured graph and its memory."""
    for graph, _, _ in _GRAPHS.values():
        graph.reset()
    _GRAPHS.clear()
    _SEEN.clear()
