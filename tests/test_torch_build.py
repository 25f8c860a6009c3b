"""The port's kernel build key (``ops/build.py``), on the CPU: no ``nvcc`` is needed to
compute it. A library is keyed by its source, every shared header and the flags, so an
edit to a header the kernels include rebuilds them instead of loading a stale library.
Each C entry point is bound once (``build.bind``) and the wrappers reuse the binding."""
import ctypes
import re
import shutil

import pytest
import torch

from bepuphysics2_tpu_torch.ops import build

KERNELS = tuple(build.KERNELS.values())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


CONTACT_KERNELS = tuple(build.KERNELS[k] for k in ("K1", "K2", "K3", "K4"))


def test_every_kernel_has_its_source():
    assert set(build.KERNELS) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"}
    for name in KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file(), name


def test_a_kernels_own_flags_enter_its_key_alone(monkeypatch):
    """K8 is built with ``-fmad=false`` (``KERNEL_FLAGS``): the flag is in its key, so a
    library built without it never loads, and in no other kernel's."""
    assert build.KERNEL_FLAGS == {"conservative_advance": ["-fmad=false"]}
    keys = {name: build.source_key(name) for name in KERNELS}
    monkeypatch.setattr(build, "KERNEL_FLAGS", {})
    for name in KERNELS:
        assert (build.source_key(name) == keys[name]) == (name != "conservative_advance"), name


def test_key_is_stable_and_distinct(csrc_copy):
    keys = {name: build.source_key(name) for name in KERNELS}
    assert len(set(keys.values())) == len(KERNELS)
    for name in KERNELS:
        assert build.source_key(name, csrc_copy) == keys[name]  # content, not location


def test_header_edit_changes_every_key(csrc_copy):
    before = {name: build.source_key(name, csrc_copy) for name in KERNELS}
    header = csrc_copy / "contact_rows.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in KERNELS:
        assert build.source_key(name, csrc_copy) != before[name], name


def test_source_edit_changes_only_its_key(csrc_copy):
    before = {name: build.source_key(name, csrc_copy) for name in KERNELS}
    src = csrc_copy / "substeps_contacts_win.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.source_key("substeps_contacts_win", csrc_copy) != before["substeps_contacts_win"]
    assert build.source_key("substeps_contacts", csrc_copy) == before["substeps_contacts"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_includes_resolve_inside_csrc(name):
    """Every quoted include of a kernel is a header in ``csrc`` (so it is in the key); the
    contact kernels K1-K4 share the per-row math of ``contact_rows.cuh``."""
    text = (build.CSRC / f"{name}.cu").read_text()
    includes = re.findall(r'#include "([^"]+)"', text)
    assert ("contact_rows.cuh" in includes) == (name in CONTACT_KERNELS)
    for inc in includes:
        assert (build.CSRC / inc).is_file(), inc


def test_bind_loads_once_and_reuses_the_binding(monkeypatch):
    """``bind`` loads a library at its first call and sets the entry point's types then;
    a second call returns the same function object without loading again."""
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None), 0.0  # the process's own symbols stand in for a kernel

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_bound", {})
    fn = build.bind("libc", "abs", [ctypes.c_int])
    assert build.bind("libc", "abs", [ctypes.c_int]) is fn
    assert loads == ["libc"]
    assert fn.restype is ctypes.c_int and list(fn.argtypes) == [ctypes.c_int]
    assert fn(-7) == 7


@pytest.mark.parametrize("module", ["sweep.py", "probes.py"])
def test_no_wrapper_loads_per_launch(module):
    """Every wrapper reaches its kernel through ``build.bind``; none calls ``build.load``
    or sets ctypes types itself."""
    text = (build.CSRC.parent / "ops" / module).read_text()
    assert "build.bind(" in text
    for banned in ("build.load(", ".restype", ".argtypes", "current_stream("):
        assert banned not in text, banned
