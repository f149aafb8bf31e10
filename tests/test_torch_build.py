"""The port's kernel build (``repro_torch.kernels._build``) on the CPU: a
library's hash covers its source and the local headers it includes,
directly or through another header, and no other header.  Nothing here
compiles (that needs ``nvcc`` and runs on the card)."""

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
    # K1 includes scan.cuh, which includes topk.cuh; K3 the bf16 MMA pieces
    # and the split; K3-bwd the bf16 pieces, the split and Hopper's (TMA,
    # wgmma)
    assert _build.includes("distance_topk.cu") == ["scan.cuh", "tf32.cuh", "topk.cuh"]
    assert _build.includes("distance_topk_q8.cu") == ["scan.cuh", "topk.cuh"]
    assert _build.includes("flash_attention.cu") == ["mma.cuh", "tf32.cuh"]
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
    ("wgmma.cuh", {"flash_attention_bwd.cu"}),
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
