"""The ablation tools time copies of a kernel with parts of its work
taken out by replacing text (tools/spmv_ablation.py on csrc/tc_spmv.cu,
tools/nbr_max_ablation.py on csrc/tc_neighbor_max.cu).  Every replaced
text must occur exactly once in the current source, so that no copy can
time an unchanged kernel.  Needs no card: the copies are built only on
one."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import nbr_max_ablation  # noqa: E402
import spmv_ablation  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("copy", [c for c in spmv_ablation.COPIES if c != "full"])
def test_spmv_ablation_texts_occur_once(copy):
    src = (CSRC / "tc_spmv.cu").read_text()
    for old, new in spmv_ablation.COPIES[copy]:
        assert src.count(old) == 1 and new != old


@pytest.mark.parametrize("part", ["keys", "max", "tile", "line", "wait"])
def test_nbr_max_ablation_texts_occur_once(part):
    src = (CSRC / "tc_neighbor_max.cu").read_text()
    form = nbr_max_ablation.form_of(src)
    assert form == "lane per tile or slot"
    for old, new in nbr_max_ablation.FORMS[form][part]:
        assert src.count(old) == 1 and new != old


def test_nbr_max_ablation_copies_all_differ_from_the_kernel():
    src = (CSRC / "tc_neighbor_max.cu").read_text()
    copies = nbr_max_ablation.copies(src)
    assert copies.pop("full") == src
    assert set(copies) == {"no keys", "no max", "no tile", "heads", "one line", "no wait"}
    assert all(text != src for text in copies.values())
    assert len(set(copies.values())) == len(copies)


def test_nbr_max_ablation_refuses_a_source_of_no_known_form():
    with pytest.raises(SystemExit, match="no known form"):
        nbr_max_ablation.form_of("__global__ void k() {}")
