"""The TPU design probes of ``experiments/`` in the PyTorch port (``ops/probes.py``,
``bepuphysics2_tpu_torch/experiments/``) against the probes' own Pallas kernels, run in
interpret mode on the CPU at the probes' full size (NB 4,096, M 1,024, 36 passes).

The probes' jitted wrappers pass no ``interpret``, so each test builds ``pl.pallas_call``
with the probe module's own kernel body, block specs and scratch shapes, and
``interpret=True``. The sweeps differ in rounding only: XLA's CPU backend contracts the
probes' arithmetic into FMAs (``g*1.0001 + 0.1`` and ``x*1.1 - 0.25*x``), where the port
rounds every operation, as its kernel K5 does; and where a pass names a body twice, the
TPU kernel's one-hot matmul sums the deltas in another order than ``index_add_``. That
is an ulp or so per pass; mode D's state grows to |x| ~ 70, so the bound is 1e-5,
absolute and relative. The gathers are exact, and so is the scatter k5, whose
read-add-set keeps the last row's write."""
import contextlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from experiments import pallas_sweep_proto as proto1
from experiments import pallas_sweep_proto2 as proto2
from experiments import pallas_sweep_proto3 as proto3
from experiments import pallas_sweep_proto4 as proto4

import torch

import bepuphysics2_tpu_torch
from bepuphysics2_tpu_torch.experiments import gather_probe, sweep_proto
from bepuphysics2_tpu_torch.ops import probes

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
F32 = jnp.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _onehots(idx, nch, lanes):
    """v2's and v3's one-hot operands, built from idx as their jitted wrappers build them."""
    hi = idx // lanes
    passes, m = idx.shape
    oh_hi = (jax.lax.broadcasted_iota(jnp.int32, (passes, m, nch), 2)
             == hi[:, :, None]).astype(jnp.bfloat16)
    oh_hi_t = (jax.lax.broadcasted_iota(jnp.int32, (passes, nch, m), 1)
               == hi[:, None, :]).astype(jnp.bfloat16)
    return oh_hi, oh_hi_t, idx % lanes


@jax.jit
def _jax_v1(v2, idx):
    return pl.pallas_call(
        proto1.sweep_kernel, out_shape=jax.ShapeDtypeStruct((proto1.NBc, 1024), F32),
        in_specs=[VMEM, VMEM], out_specs=VMEM,
        scratch_shapes=[pltpu.VMEM((proto1.NBc, 1024), F32)], interpret=True)(idx, v2)


def _jax_v2(mode):
    @jax.jit
    def fn(v2, idx):
        oh_hi, oh_hi_t, lo = _onehots(idx, proto2.NBc, 128)
        return pl.pallas_call(
            proto2.make_kernel(mode), out_shape=jax.ShapeDtypeStruct((proto2.NBc, 1024), F32),
            in_specs=[VMEM] * 4, out_specs=VMEM,
            scratch_shapes=[pltpu.VMEM((proto2.NBc, 1024), F32)],
            interpret=True)(oh_hi, oh_hi_t, lo, v2)

    return fn


@jax.jit
def _jax_v3(vt, idx):
    oh_hi, oh_hi_t, lo = _onehots(idx, proto3.NBc, 128)
    return pl.pallas_call(
        proto3.kernel, out_shape=jax.ShapeDtypeStruct((1024, proto3.NBc), F32),
        in_specs=[VMEM] * 4, out_specs=VMEM,
        scratch_shapes=[pltpu.VMEM((1024, proto3.NBc), F32)],
        interpret=True)(oh_hi_t, oh_hi, lo.reshape(proto3.PASSES, 1, proto3.M), vt)


@jax.jit
def _jax_v4(vt, idx):
    m = proto4

    def kern(ohhit_ref, ohhi_ref, lo_ref, vin_ref, vout_ref, vstate):
        return m.kernel(ohhit_ref.at[0], ohhi_ref.at[0], lo_ref.at[0], vin_ref, vout_ref,
                        vstate)

    return pl.pallas_call(
        kern, grid=(m.PASSES,),
        in_specs=[
            pl.BlockSpec((1, m.NCH, m.M), lambda p: (p, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, m.M, m.NCH), lambda p: (p, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, m.M), lambda p: (p, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((m.C8, m.NCH), lambda p: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((m.C8, m.NCH), lambda p: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m.C8, m.NCH), F32),
        scratch_shapes=[pltpu.VMEM((m.C8, m.NCH), F32)], interpret=True,
    )(*m.build_onehots(idx), vt)


# The port's variant -> (the JAX kernel, the probe module's own layout helpers)
JAX_SWEEPS = {
    "v1": (_jax_v1, proto1.to_v2, proto1.from_v2),
    "v2-A": (_jax_v2("A"), proto2.to_v2, proto2.from_v2),
    "v2-B": (_jax_v2("B"), proto2.to_v2, proto2.from_v2),
    "v2-C": (_jax_v2("C"), proto2.to_v2, proto2.from_v2),
    "v2-D": (_jax_v2("D"), proto2.to_v2, proto2.from_v2),
    "v3": (_jax_v3, proto3.to_vt, proto3.from_vt),
    "v4": (_jax_v4, proto4.to_vt, proto4.from_vt),
}
VARIANTS = {name: (fn, lanes, transposed, mode)
            for name, fn, lanes, transposed, mode in sweep_proto.VARIANTS}


def test_variants_cover_every_jax_sweep():
    assert set(VARIANTS) == set(JAX_SWEEPS)
    assert (sweep_proto.NB, sweep_proto.M, sweep_proto.PASSES) == (proto1.NB, proto1.M,
                                                                   proto1.PASSES)


def test_inputs_are_the_prototypes_own():
    v6, idx = sweep_proto.inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(v6, rng.normal(size=(proto1.NB, 8)).astype(np.float32))
    np.testing.assert_array_equal(idx[0], rng.permutation(proto1.NB)[:proto1.M])
    assert all(len(np.unique(p)) == proto1.M for p in idx)  # no body twice in a pass
    _, dup = sweep_proto.inputs_with_duplicates()
    assert min(proto1.M - len(np.unique(p)) for p in dup) > 50


@pytest.mark.parametrize("duplicates", [False, True], ids=["permutation", "duplicates"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_sweep_matches_jax_kernel(variant, duplicates):
    fn, lanes, transposed, mode = VARIANTS[variant]
    jfn, jto, jfrom = JAX_SWEEPS[variant]
    v6, idx = sweep_proto.inputs_with_duplicates() if duplicates else sweep_proto.inputs()
    want = jfrom(jfn(jnp.asarray(jto(v6)), jnp.asarray(idx)))
    state = probes.to_state(torch.from_numpy(v6), lanes, transposed)
    np.testing.assert_array_equal(state.numpy(), jto(v6))  # the same layout as the probe
    got = fn(state, torch.from_numpy(idx))
    assert got.shape == state.shape
    np.testing.assert_allclose(probes.to_rows(got, lanes, transposed).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    moved = np.abs(want - v6).max()
    if mode == "C":  # 1e-30 of a pass's sum is below f32 resolution at state[0, 0]
        assert moved <= 1e-6
    else:
        assert moved > 1e-1


def test_plain_sweep_matches_xla_sweep():
    """The prototypes' own reference (``xla_sweep``: fancy-index gather, the arithmetic,
    ``.at[].add``) on (NB, 8) rows, with and without repeated indices. XLA's FMAs round
    differently (module docstring): within 1e-6 at |x| < 1, and not bit-equal."""
    for v6, idx in (sweep_proto.inputs(), sweep_proto.inputs_with_duplicates()):
        want = np.asarray(proto1.xla_sweep(jnp.asarray(v6), jnp.asarray(idx)))
        rows = torch.from_numpy(v6.copy())
        for p in torch.from_numpy(idx).long():
            probes._sweep_pass_plain(rows, p, 128, "B")
        assert np.abs(want).max() < 1.0
        np.testing.assert_allclose(rows.numpy(), want, rtol=0, atol=1e-6)


def test_xla_contracts_the_probe_arithmetic_into_fmas():
    """Why the port and JAX differ by an ulp: XLA's CPU result for ``math_block`` equals
    the arithmetic with both contractions (fma(g, 1.0001, 0.1), fma(x, 1.1, -0.25x),
    each rounded once from float64) bit for bit, and not the port's rounding of every
    operation."""
    g = np.random.default_rng(0).normal(size=20000).astype(np.float32)
    want = np.asarray(jax.jit(proto1.math_block)(jnp.asarray(g)))

    def fma(a, b, c):
        return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(np.float32)

    x = fma(g, np.float32(1.0001), np.float32(0.1))
    for _ in range(6):
        x = fma(x, np.float32(1.1), -(np.float32(0.25) * x))
    np.testing.assert_array_equal(x - g, want)
    port = probes.math_block(torch.from_numpy(g)).numpy()
    assert np.abs(port - want).max() <= 1e-6 and (port != want).any()


@pytest.mark.parametrize("lanes, transposed, jto, jfrom", [
    (128, False, proto1.to_v2, proto1.from_v2),
    (128, True, proto3.to_vt, proto3.from_vt),
    (8, True, proto4.to_vt, proto4.from_vt),
], ids=["v2", "vt128", "vt8"])
def test_layout_helpers_invert_each_other_and_match_the_probes(lanes, transposed, jto, jfrom):
    v6, _ = sweep_proto.inputs()
    rows = torch.from_numpy(v6)
    if transposed:
        state = sweep_proto.to_vt(rows, lanes)
        back = sweep_proto.from_vt(state, lanes)
    else:
        state = sweep_proto.to_v2(rows)
        back = sweep_proto.from_v2(state)
    np.testing.assert_array_equal(state.numpy(), jto(v6))
    np.testing.assert_array_equal(back.numpy(), v6)
    np.testing.assert_array_equal(jfrom(state.numpy()), v6)
    assert state.is_contiguous() and back.is_contiguous()


# --- the gather and scatter probes -----------------------------------------------------

@pytest.fixture(scope="module")
def gprobe():
    """``experiments/pallas_gather_probe.py``, which runs its six probes when imported:
    on the CPU each prints FAIL (no interpret mode), so its output is dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        from experiments import pallas_gather_probe
    return pallas_gather_probe


def _jax_gather(gp, kernel, idx_space=pltpu.VMEM):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((gp.M, 8), F32),
        in_specs=[VMEM, pl.BlockSpec(memory_space=idx_space)], out_specs=VMEM,
        interpret=True)(gp.v6, gp.idx))


def test_gather_probe_inputs_are_the_probes_own(gprobe):
    v, idx, d = gather_probe.inputs()
    np.testing.assert_array_equal(v.numpy(), np.asarray(gprobe.v6))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(gprobe.idx))
    assert d.shape == (gprobe.M, 8) and (d == 1).all()
    assert gprobe.M - len(np.unique(idx.numpy())) > 0  # repeated indices


@pytest.mark.parametrize("label", ["k1", "k2", "k3", "k4", "k6"])
def test_gather_probes_equal_jax(gprobe, label):
    space = pltpu.SMEM if label == "k4" else pltpu.VMEM
    want = _jax_gather(gprobe, getattr(gprobe, label), space)
    v, idx, _ = gather_probe.inputs()
    got = getattr(gather_probe, label)(v, idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_probe_keeps_the_last_writer_as_jax(gprobe):
    """k5 with distinct ``d`` rows: the port equals the TPU kernel exactly, and both
    differ from the accumulating and the first-writer scatters (the indices repeat)."""
    v, idx, _ = gather_probe.inputs()
    d = np.random.default_rng(3).normal(size=(gprobe.M, 8)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        gprobe.k5, out_shape=jax.ShapeDtypeStruct((gprobe.NB, 8), F32),
        in_specs=[VMEM] * 3, out_specs=VMEM, interpret=True)(gprobe.v6, gprobe.idx,
                                                              jnp.asarray(d)))
    got = gather_probe.k5(v, idx, torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    vv, ii = v.numpy(), idx.numpy()
    acc = vv.copy()
    np.add.at(acc, ii, d)
    first = vv.copy()
    for j in range(len(ii) - 1, -1, -1):
        first[ii[j]] = vv[ii[j]] + d[j]
    assert np.abs(got - acc).max() > 0 and np.abs(got - first).max() > 0


# --- wrappers, entry points, imports ---------------------------------------------------

def test_sweep_wrapper_checks_its_inputs():
    v6, idx = sweep_proto.inputs()
    v2, idx_t = sweep_proto.to_v2(torch.from_numpy(v6)), torch.from_numpy(idx)
    kw = dict(lanes=128, transposed=False)
    with pytest.raises(TypeError, match="idx"):
        probes.probe_sweep(v2, idx_t.long(), **kw)
    with pytest.raises(TypeError, match="state"):
        probes.probe_sweep(v2.double(), idx_t, **kw)
    with pytest.raises(ValueError, match="layout"):
        probes.probe_sweep(v2, idx_t, lanes=128, transposed=True)
    with pytest.raises(ValueError, match="contiguous"):
        probes.probe_sweep(v2.t().contiguous().t(), idx_t, **kw)
    with pytest.raises(ValueError, match="mode"):
        probes.probe_sweep(v2, idx_t, mode="E", **kw)
    with pytest.raises(ValueError, match="shared memory"):  # 8,192 bodies: 262,144 B of state
        probes.probe_sweep(torch.zeros(64, 1024), idx_t, **kw)
    assert probes.sweep_smem_bytes(4096, 1024) <= probes.SMEM_LIMIT
    before = probes.probe_sweep.launches
    out = probes.probe_sweep(v2, idx_t, **kw)
    assert probes.probe_sweep.launches == before  # the CPU runs the plain version
    assert out.shape == v2.shape and out.dtype == torch.float32


def test_gather_and_scatter_wrappers_check_their_inputs():
    v, idx, d = gather_probe.inputs()
    with pytest.raises(TypeError, match="idx"):
        probes.probe_gather(v, idx.long())
    with pytest.raises(ValueError, match="expected"):
        probes.probe_gather(v.reshape(-1), idx)
    with pytest.raises(ValueError, match="d has shape"):
        probes.probe_scatter(v, idx, d[:-1])
    with pytest.raises(TypeError, match="v has dtype"):
        probes.probe_scatter(v.double(), idx, d)
    before = (probes.probe_gather.launches, probes.probe_scatter.launches)
    probes.probe_gather(v, idx)
    probes.probe_scatter(v, idx, d)
    assert (probes.probe_gather.launches, probes.probe_scatter.launches) == before


def test_entry_points_run_on_the_cpu(capsys):
    rows = sweep_proto.main("cpu", iters=1)
    assert [r["name"] for r in rows] == list(VARIANTS)
    assert all(r["max_abs_err"] == 0.0 and r["ms"] > 0 for r in rows)
    rows = gather_probe.main("cpu", iters=1)
    assert [r["label"] for r in rows] == ["k1", "k2", "k3", "k4", "k5", "k6"]
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    out = capsys.readouterr().out
    assert out.count("OK   ") == 6 and "us/pass" in out


def test_port_imports_no_jax_no_jax_package_no_experiments():
    pkg = Path(bepuphysics2_tpu_torch.__file__).parent
    root = pkg.parent
    code = ("import sys, importlib, pkgutil\n"
            "import bepuphysics2_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'bepuphysics2_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'bepuphysics2_tpu', 'experiments'))\n"
            "assert 'bepuphysics2_tpu_torch.experiments.sweep_proto' in sys.modules\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
    for src in [*pkg.rglob("*.py"), root / "chip_smoke.py"]:
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "bepuphysics2_tpu", "experiments"), (src, line)
