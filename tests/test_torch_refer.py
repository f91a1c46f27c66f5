"""The port's REFER API (cris_tpu_torch/data/refer.py) against the JAX
package's on the same inputs: the polygon rasterizer bit for bit against
cv2.fillPoly (hypothesis-drawn polygon lists and the committed fixture of
tests/torch_prep_fixtures, which chip_smoke.py phase 19 checks on the
card's machine by its digests), both RLE decoders, and every getter and
split filter on one fake REFER root."""

import hashlib
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from cris_tpu.data import refer as jax_refer
from cris_tpu_torch.data import refer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_prep_fixtures")


# ------------------------------------------------------------ rasterizer


def _coord(lo: int, hi: int):
    """A vertex coordinate as COCO stores it: two decimals, or a .5 that
    np.round takes to the even neighbour."""
    return st.one_of(
        st.integers(2 * lo, 2 * hi).map(lambda v: v / 2),
        st.floats(lo, hi, allow_nan=False).map(lambda v: round(v, 2)))


@st.composite
def _part(draw, h: int, w: int):
    """One polygon part: free vertices (in any order, so self-intersecting
    as often as not), vertices drawn from a pool of 1 to 4 points
    (repeated), or integer points on one line (collinear); 1 to 40 of
    them, as far as half the image outside it."""
    n = draw(st.integers(1, 40))
    xs, ys = _coord(-w // 2 - 2, w + w // 2 + 2), _coord(-h // 2 - 2,
                                                         h + h // 2 + 2)
    kind = draw(st.sampled_from(["free", "pool", "line"]))
    if kind == "free":
        pts = draw(st.lists(st.tuples(xs, ys), min_size=n, max_size=n))
    elif kind == "pool":
        pool = draw(st.lists(st.tuples(xs, ys), min_size=1, max_size=4))
        pts = [pool[i] for i in draw(st.lists(
            st.integers(0, len(pool) - 1), min_size=n, max_size=n))]
    else:
        x0, y0 = draw(st.integers(-w, 2 * w)), draw(st.integers(-h, 2 * h))
        dx, dy = draw(st.integers(-6, 6)), draw(st.integers(-6, 6))
        pts = [(x0 + t * dx, y0 + t * dy) for t in draw(st.lists(
            st.integers(-40, 40), min_size=n, max_size=n))]
    return [c for p in pts for c in p]


@st.composite
def _polygon_cases(draw):
    if draw(st.booleans()):
        h, w = draw(st.integers(1, 6)), draw(st.integers(1, 6))
    else:
        h, w = draw(st.integers(1, 480)), draw(st.integers(1, 640))
    parts = draw(st.lists(_part(h, w), min_size=1, max_size=3))
    return parts, h, w


@settings(max_examples=400, deadline=None)
@given(_polygon_cases())
def test_rasterize_polygons_equals_cv2_fillpoly(case):
    parts, h, w = case
    ours = refer.rasterize_polygons(parts, h, w)
    theirs = jax_refer.rasterize_polygons(parts, h, w)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def _fixture():
    with open(os.path.join(FIXTURES, "polygons.json")) as f:
        cases = json.load(f)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)["masks"]
    return dict(zip([c["name"] for c in cases], zip(cases, digests)))


@pytest.mark.parametrize("name", sorted(_fixture()))
def test_rasterizer_fixture_matches_cv2_and_its_digests(name):
    """The committed annotations (24 COCO-like ones of 20 to 100 vertices
    at 640 x 480, and the hard cases) give cv2.fillPoly's mask here and
    the committed digest."""
    case, digest = _fixture()[name]
    args = case["segmentation"], case["height"], case["width"]
    ours = refer.rasterize_polygons(*args)
    np.testing.assert_array_equal(ours, jax_refer.rasterize_polygons(*args))
    assert hashlib.sha256(ours.tobytes()).hexdigest() == digest


def test_fixture_has_the_cases_phase_19_relies_on():
    fixture = _fixture()
    coco = [c for c, _ in fixture.values() if c["name"].startswith("coco_")]
    assert len(coco) >= 20 and len(fixture) == len(coco) + 16
    for case in coco:
        assert (case["height"], case["width"]) == (480, 640)
        assert all(20 <= len(p) // 2 <= 100 for p in case["segmentation"])
    assert chip_smoke.check_rasterizer_fixture() == len(fixture)


@pytest.mark.parametrize("case", [
    ([[]], 5, 6),          # a part without vertices: OpenCV refuses it
    ([[1, 2, 3]], 5, 6),   # an odd number of coordinates
])
def test_rasterize_refuses_what_the_jax_function_refuses(case):
    with pytest.raises(Exception):
        jax_refer.rasterize_polygons(*case)
    with pytest.raises(ValueError):
        refer.rasterize_polygons(*case)


# ------------------------------------------------------------------ RLE


@pytest.mark.parametrize("seed", range(6))
def test_rle_decoders_equal_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = int(rng.randint(1, 120)), int(rng.randint(1, 160))
    cuts = np.sort(rng.choice(np.arange(1, h * w), min(h * w - 1,
                                                       rng.randint(0, 60)),
                              replace=False)) if h * w > 1 else []
    counts = np.diff(np.concatenate([[0], cuts, [h * w]])).astype(int).tolist()
    if rng.rand() < 0.5:
        counts = [0] + counts  # the mask starts with ones
    ours = refer.decode_uncompressed_rle(counts, h, w)
    np.testing.assert_array_equal(
        ours, jax_refer.decode_uncompressed_rle(counts, h, w))
    assert ours.shape == (h, w) and ours.sum() == sum(counts[1::2])
    text = chip_smoke.rle_string(counts)
    assert refer.decode_compressed_counts(text) == counts
    assert refer.decode_compressed_counts(text.encode()) == \
        jax_refer.decode_compressed_counts(text) == counts


def test_rle_counts_round_trip():
    mask = np.zeros((7, 9), np.uint8)
    mask[2:5, 3:8] = 1
    counts = chip_smoke.rle_counts(mask)
    np.testing.assert_array_equal(refer.decode_uncompressed_rle(counts, 7, 9),
                                  mask)
    mask[0, 0] = 1
    assert chip_smoke.rle_counts(mask)[0] == 0


# ---------------------------------------------------------------- REFER

SPLITS = {"train": 6, "val": 3, "testA": 2, "testB": 2, "testC": 2,
          "testAB": 1, "testBC": 1, "testAC": 1, "test": 2}


@pytest.fixture(scope="module")
def refers(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("refer"))
    chip_smoke.write_refer_root(root, seed=3, splits=SPLITS, n_images=5,
                                size=(96, 72))
    return (refer.REFER(root, "refcoco", "unc"),
            jax_refer.REFER(root, "refcoco", "unc"))


@pytest.mark.parametrize("split", sorted(SPLITS) + ["bad"])
def test_refer_split_filter_equals_jax(refers, split):
    ours, theirs = refers
    if split == "bad":
        for api in refers:
            with pytest.raises(KeyError):
                api.getRefIds(split=split)
        return
    ids = ours.getRefIds(split=split)
    assert ids == theirs.getRefIds(split=split) and ids
    if split in ("testA", "testB", "testC"):
        assert len(ids) > SPLITS[split]  # testAB and the like count too


def test_refer_getters_and_filters_equal_jax(refers):
    ours, theirs = refers
    for name in ("Refs", "Anns", "Imgs", "Cats", "imgToAnns", "imgToRefs",
                 "catToRefs", "annToRef", "Sents", "sentToRef",
                 "sentToTokens"):
        assert getattr(ours, name) == getattr(theirs, name), name
    img_ids, cat_ids = ours.getImgIds(), ours.getCatIds()
    ref_ids = ours.getRefIds()
    assert img_ids == theirs.getImgIds() and cat_ids == theirs.getCatIds()
    assert ref_ids == theirs.getRefIds()
    cat_of_refs = sorted({r["category_id"] for r in ours.Refs.values()})
    for kwargs in ({"image_ids": img_ids[0]}, {"image_ids": img_ids[:3]},
                   {"cat_ids": cat_of_refs[0]}, {"cat_ids": cat_of_refs},
                   {"ref_ids": ref_ids[:4]},
                   {"image_ids": img_ids[1:], "split": "train"},
                   {"cat_ids": cat_of_refs, "ref_ids": ref_ids[2:9],
                    "split": "test"}):
        assert ours.getRefIds(**kwargs) == theirs.getRefIds(**kwargs), kwargs
    for kwargs in ({}, {"image_ids": img_ids[:2]}, {"ref_ids": ref_ids[:3]},
                   {"image_ids": img_ids[2], "ref_ids": ref_ids}):
        assert sorted(ours.getAnnIds(**kwargs)) == sorted(
            theirs.getAnnIds(**kwargs)), kwargs
    assert sorted(ours.getImgIds(ref_ids[:5])) == sorted(
        theirs.getImgIds(ref_ids[:5]))
    assert ours.loadRefs(ref_ids[:3]) == theirs.loadRefs(ref_ids[:3])
    ann_ids = ours.getAnnIds()
    assert ours.loadAnns(ann_ids[-2:]) == theirs.loadAnns(ann_ids[-2:])
    assert ours.loadImgs(img_ids[0]) == theirs.loadImgs(img_ids[0])
    assert ours.loadCats(cat_ids[:4]) == theirs.loadCats(cat_ids[:4])
    for ref_id in ref_ids:
        assert ours.getRefBox(ref_id) == theirs.getRefBox(ref_id)


def test_refer_masks_equal_jax(refers):
    """Every ref's mask and area; the root holds polygon lists, raw RLE
    and compressed RLE, so all three decoders run."""
    ours, theirs = refers
    kinds = set()
    for ref in ours.Refs.values():
        seg = ours.Anns[ref["ann_id"]]["segmentation"]
        kinds.add("polygons" if isinstance(seg, list) else
                  type(seg["counts"]).__name__)
        a, b = ours.getMask(ref), theirs.getMask(ref)
        assert a["area"] == b["area"]
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["mask"].dtype == np.uint8
    assert kinds == {"polygons", "list", "str"}, kinds


def test_refer_refuses_unknown_dataset(tmp_path):
    with pytest.raises(KeyError):
        refer.REFER(str(tmp_path), "refcocox", "unc")
