"""The kernel build's cache key, on the CPU (no nvcc needed).

A library's name carries a hash of its source, of every shared header in
``csrc`` and of the flags: an edited header must rebuild every library,
or a kernel would run with stale helpers.
"""

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return src


def test_a_changed_header_changes_every_target(csrc):
    before = {n: _build._target(n) for n in ("a", "b")}
    (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert all(t.parent == _build.build_dir() for t in after.values())


def test_a_new_header_changes_the_target(csrc):
    before = _build._target("a")
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build._target("a") != before


def test_the_target_is_stable_and_follows_its_source(csrc):
    assert _build._target("a") == _build._target("a")
    assert _build._target("a") != _build._target("b")
    before = _build._target("b")
    (csrc / "b.cu").write_text("int b2;\n")
    assert _build._target("b") != before
    assert _build._target("b").name.startswith("libb-")


def test_the_repository_headers_are_hashed():
    """csrc/tc_common.cuh, which the attention kernels include, is a
    header the digest sees."""
    assert (_build.CSRC / "tc_common.cuh").exists()
    assert "tc_common.cuh" in (_build.CSRC / "prefill_attention.cu").read_text()
    assert "tc_common.cuh" in (_build.CSRC / "flash_attention.cu").read_text()
