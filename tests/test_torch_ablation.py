"""The ablation tools time copies of a kernel with parts of its work
taken out by replacing text (tools/spmv_ablation.py on csrc/tc_spmv.cu,
tools/nbr_max_ablation.py on csrc/tc_neighbor_max.cu,
tools/bag_ablation.py on csrc/embedding_bag.cu, tools/spmv_bits_ablation.py
on csrc/tc_spmv_bits.cu).  Every replaced
text must occur exactly once in the current source, so that no copy can
time an unchanged kernel.  Needs no card: the copies are built only on
one."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import bag_ablation  # noqa: E402
import nbr_max_ablation  # noqa: E402
import spmv_ablation  # noqa: E402
import spmv_bits_ablation  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("copy", [c for c in spmv_ablation.COPIES if c != "full"])
def test_spmv_ablation_texts_occur_once(copy):
    src = (CSRC / "tc_spmv.cu").read_text()
    for old, new in spmv_ablation.COPIES[copy]:
        assert src.count(old) == 1 and new != old


@pytest.mark.parametrize("part", ["keys", "max", "tile", "line", "wait"])
def test_nbr_max_ablation_texts_occur_once(part):
    src = (CSRC / "tc_neighbor_max.cu").read_text()
    form = spmv_ablation.form_of(src, nbr_max_ablation.FORMS)
    assert form == "lane per tile or slot"
    for old, new in nbr_max_ablation.PARTS[form][part]:
        assert src.count(old) == 1 and new != old


def test_nbr_max_ablation_copies_all_differ_from_the_kernel():
    src = (CSRC / "tc_neighbor_max.cu").read_text()
    copies = spmv_ablation.copies_of(src, nbr_max_ablation.FORMS)
    assert copies.pop("full") == src
    assert set(copies) == {"no keys", "no max", "no tile", "heads", "one line", "no wait"}
    assert all(text != src for text in copies.values())
    assert len(set(copies.values())) == len(copies)


def test_nbr_max_ablation_refuses_a_source_of_no_known_form():
    with pytest.raises(SystemExit, match="no known form"):
        spmv_ablation.form_of("__global__ void k() {}", nbr_max_ablation.FORMS)


# the tools that keep their copies per form of the source: the form the
# current source has, and the source
FORM_TOOLS = {
    "bag": (bag_ablation, "lane group per bag", "embedding_bag.cu"),
    "spmv_bits": (spmv_bits_ablation, "lane per tile", "tc_spmv_bits.cu"),
}


@pytest.mark.parametrize("copy", ["no index", "no row", "both out"])
def test_bag_ablation_texts_occur_once(copy):
    tool, form, source = FORM_TOOLS["bag"]
    src = (CSRC / source).read_text()
    assert spmv_ablation.form_of(src, tool.FORMS) == form
    for old, new in tool.FORMS[form][copy]:
        assert src.count(old) == 1 and new != old


@pytest.mark.parametrize("source, forms, copy", [
    ("embedding_bag.cu", "BACKWARD_FORMS", "no segments"),
    ("embedding_bag.cu", "BACKWARD_FORMS", "no sums"),
    ("embedding_bag.cu", "BACKWARD_FORMS", "no dense"),
    ("embedding_bag.cu", "BACKWARD_FORMS", "writes only"),
    ("slot_sort.cu", "SORT_FORMS", "sort only")])
def test_bag_backward_ablation_texts_occur_once(source, forms, copy):
    src = (CSRC / source).read_text()
    forms = getattr(bag_ablation, forms)
    for old, new in forms[spmv_ablation.form_of(src, forms)][copy]:
        assert src.count(old) == 1 and new != old


@pytest.mark.parametrize("copy", ["no tile", "no cand", "heads"])
def test_spmv_bits_ablation_texts_occur_once(copy):
    tool, form, source = FORM_TOOLS["spmv_bits"]
    src = (CSRC / source).read_text()
    assert spmv_ablation.form_of(src, tool.FORMS) == form
    for old, new in tool.FORMS[form][copy]:
        assert src.count(old) == 1 and new != old


def test_spmv_bits_lane_per_tile_texts_reach_both_kernels():
    """The lane-per-tile texts sit in the one template that the fused and
    the split kernel both launch at T <= 16, so every copy times both in
    the new form."""
    src = (CSRC / "tc_spmv_bits.cu").read_text()
    start = src.index("spmv_bits_tile_lanes(const Args a)")
    end = src.index("__global__", start)
    for old, _ in spmv_bits_ablation._TILE_LANES.values():
        assert start < src.index(old) < end
    assert "launch_tile_lanes<T, true>" in src and "launch_tile_lanes<T, false>" in src


@pytest.mark.parametrize("tool", sorted(FORM_TOOLS))
def test_form_tools_copies_all_differ_from_the_kernel(tool):
    module, _, source = FORM_TOOLS[tool]
    src = (CSRC / source).read_text()
    copies = spmv_ablation.copies_of(src, module.FORMS)
    assert copies.pop("full") == src
    assert set(copies) == set(next(iter(module.FORMS.values())))
    assert all(text != src for text in copies.values())
    assert len(set(copies.values())) == len(copies)


def test_form_tools_refuse_a_source_of_no_known_form():
    with pytest.raises(SystemExit, match="no known form"):
        spmv_ablation.form_of("__global__ void k() {}", bag_ablation.FORMS)
