"""The port's kernel build (``repro_torch.kernels._build``) on the CPU: a
library's hash covers its source and the local headers it includes,
directly or through another header, and no other header.  Nothing here
compiles (that needs ``nvcc`` and runs on the card)."""

import re
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build


def test_every_source_exists_with_its_headers():
    for source in _build.SOURCES:
        assert (_build.CSRC / source).is_file()
        for header in _build.includes(source):
            assert (_build.CSRC / header).is_file()


def test_includes_are_followed_through_headers():
    # K1 includes scan.cuh, which includes topk.cuh; K3 and K3-bwd the bf16
    # MMA pieces, the split and Hopper's (TMA, wgmma), which include the bf16
    # pieces too
    assert _build.includes("distance_topk.cu") == ["scan.cuh", "tf32.cuh", "topk.cuh"]
    assert _build.includes("distance_topk_q8.cu") == ["scan.cuh", "topk.cuh"]
    assert _build.includes("flash_attention.cu") == ["mma.cuh", "tf32.cuh", "wgmma.cuh"]
    assert _build.includes("flash_attention_bwd.cu") == ["mma.cuh", "tf32.cuh", "wgmma.cuh"]


@pytest.fixture()
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    return d


def _paths(csrc):
    return {s: _build.library_path(s, csrc) for s in _build.SOURCES}


@pytest.mark.parametrize("edited,rebuilt", [
    ("flash_attention.cu", {"flash_attention.cu"}),
    ("flash_attention_bwd.cu", {"flash_attention_bwd.cu"}),
    ("mma.cuh", {"flash_attention.cu", "flash_attention_bwd.cu"}),
    ("wgmma.cuh", {"flash_attention.cu", "flash_attention_bwd.cu"}),
    ("tf32.cuh", {"distance_topk.cu", "flash_attention.cu", "flash_attention_bwd.cu"}),
    ("topk.cuh", {"distance_topk.cu", "distance_topk_q8.cu"}),
    ("scan.cuh", {"distance_topk.cu", "distance_topk_q8.cu"}),
    ("distance_topk_q8.cu", {"distance_topk_q8.cu"}),
])
def test_an_edit_rebuilds_only_what_includes_it(csrc, edited, rebuilt):
    before = _paths(csrc)
    assert before == _paths(_build.CSRC)  # the hash depends on contents, not the directory
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = _paths(csrc)
    assert {s for s in _build.SOURCES if after[s] != before[s]} == rebuilt


def test_a_new_unincluded_header_rebuilds_nothing(csrc):
    before = _paths(csrc)
    (csrc / "unused.cuh").write_text("#pragma once\n")
    assert _paths(csrc) == before


def test_k1_and_k2_build_each_k_pad_instance_as_its_own_unit(monkeypatch):
    """K1 and K2 compile as four translation units each, the C entry and one
    unit a k_pad instance (``-DREPRO_K``), so the build's longest compiles
    run in parallel; K3-bwd's source is one unit.  The units are part of a
    library's hash."""
    for source in ("distance_topk.cu", "distance_topk_q8.cu"):
        units = _build.UNITS[source]
        assert units == ((), ("-DREPRO_K=128",), ("-DREPRO_K=256",), ("-DREPRO_K=512",))
        text = (_build.CSRC / source).read_text()
        assert "#ifdef REPRO_K" in text and "<REPRO_K>(" in text
    assert "flash_attention_bwd.cu" not in _build.UNITS
    before = _build.library_path("distance_topk.cu")
    monkeypatch.setitem(_build.UNITS, "distance_topk.cu", _build.UNITS["distance_topk.cu"][:2])
    assert _build.library_path("distance_topk.cu") != before


def test_k3_builds_its_entry_and_each_dtype_as_its_own_unit(monkeypatch):
    """K3 compiles as three translation units: the C entry, the bfloat16
    instances (``-DREPRO_K3_BF16``, the warp-specialised wgmma kernel, the
    longest compile) and the float32 ones (``-DREPRO_K3_F32``), so that
    the first-use build runs them in parallel.  The source defines each
    dtype's launcher for every instance behind its define and calls them
    from the entry built with neither; the units are part of the hash."""
    units = _build.UNITS["flash_attention.cu"]
    assert units == ((), ("-DREPRO_K3_BF16",), ("-DREPRO_K3_F32",))
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for define, launcher in (("REPRO_K3_BF16", "k3_launch_bf16"), ("REPRO_K3_F32", "k3_launch_f32")):
        assert f"#ifdef {define}" in text and f"cudaError_t {launcher}(K3_LAUNCH_ARGS)" in text
    instances = re.findall(r"^K3_INSTANCE\((\d+), (\d+)\)$", text, re.MULTILINE)
    from repro_torch.kernels.flash_attention import INSTANCES
    assert [(int(a), int(b)) for a, b in instances] == list(INSTANCES)
    assert 'extern "C" int repro_flash_attention(' in text
    # bfloat16 runs the wgmma kernel: the mma.sync one and its MMA are gone
    assert "flash_fwd_wgmma_kernel" in text
    assert "flash_fwd_mma_kernel" not in text and "mma_bf16(" not in text
    before = _build.library_path("flash_attention.cu")
    monkeypatch.setitem(_build.UNITS, "flash_attention.cu", units[:2])
    assert _build.library_path("flash_attention.cu") != before


class _FakeNvcc:
    """Records each nvcc command; a link writes its library."""

    def __init__(self):
        self.cmds = []

    def __call__(self, cmd):
        self.cmds.append(cmd)
        if "-shared" in cmd and "-c" not in cmd:
            open(cmd[cmd.index("-o") + 1], "w").close()
        fake = type("P", (), {"returncode": 0})()
        fake.communicate = lambda: ("ptxas info : Used 32 registers\n", None)
        return fake


def test_build_all_compiles_every_unit_then_links_each_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    fake = _FakeNvcc()
    monkeypatch.setattr(_build, "_run", fake)
    logs = _build.build_all(("distance_topk.cu", "flash_attention.cu"))
    compiles = [c for c in fake.cmds if "-c" in c]
    links = [c for c in fake.cmds if "-c" not in c]
    assert len(compiles) == 7 and len(links) == 2  # 4 units + 3, then one link a library
    assert all("-shared" not in c for c in compiles)
    assert sorted(d for c in compiles for d in c if d.startswith("-DREPRO_K")) == [
        "-DREPRO_K3_BF16", "-DREPRO_K3_F32", "-DREPRO_K=128", "-DREPRO_K=256", "-DREPRO_K=512"]
    k3_link = next(c for c in links if "flash_attention" in c[c.index("-o") + 1])
    assert len([a for a in k3_link if a.endswith(".o")]) == 3
    k1_link = next(c for c in links if "distance_topk" in c[c.index("-o") + 1])
    assert len([a for a in k1_link if a.endswith(".o")]) == 4
    for source in ("distance_topk.cu", "flash_attention.cu"):
        assert _build.library_path(source).exists()
        assert "registers" in logs[source]
    assert not list(tmp_path.glob("*.o")) and not list(tmp_path.glob("*.tmp"))
    assert _build.build_all(("distance_topk.cu",)) == {}  # built: nothing to do
