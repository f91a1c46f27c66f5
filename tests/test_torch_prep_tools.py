"""The port's dataset preparation against the JAX package's tools on the
same fake REFER roots (chip_smoke.write_refer_root): python3 -m
cris_tpu_torch.data_process (annotation JSON byte-equal to
tools/data_process.py's, masks that decode to the same pixels),
cris_tpu_torch.folder2pack (RefPack files byte-equal to
tools/folder2pack.py's, and --from-lmdb through a stub lmdb module),
.lmdb URIs in open_backend, and cris_tpu_torch.prewarp (records within the
bars of tools/prewarp.py's, and samples equal to the port's live path on
the raw pack bit for bit, per sample and through the native data plane)."""

import importlib.util
import json
import os
import pickle
import sys
import types

import cv2
import numpy as np
import pytest

import chip_smoke
from cris_tpu.data import refer as jax_refer
from cris_tpu_torch import data_process, folder2pack, prewarp
from cris_tpu_torch.data import (RefDataLoader, RefDataset, RefPackReader,
                                 decode_mask, open_backend)
from cris_tpu_torch.data import lmdb_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO_SPLITS = {"train": 6, "val": 3, "testA": 2, "testB": 2}
SIZE = 416


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _prepare(monkeypatch, root, out, dataset, split_by, tool):
    """Run one package's data_process main on a root."""
    argv = ["--data_root", root, "--output_dir", out, "--dataset", dataset,
            "--split", split_by, "--generate_mask"]
    if tool == "port":
        data_process.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["data_process.py"] + argv)
        _jax_tool("data_process").main()


def _assert_same_outputs(ours, theirs, dataset):
    """Byte-equal annotation JSON, and mask PNGs that decode to the same
    pixels under cv2.imdecode and the port's decoder."""
    ann = os.path.join("anns", dataset)
    names = sorted(os.listdir(os.path.join(theirs, ann)))
    assert sorted(os.listdir(os.path.join(ours, ann))) == names
    for name in names:
        with open(os.path.join(ours, ann, name), "rb") as a, \
                open(os.path.join(theirs, ann, name), "rb") as b:
            assert a.read() == b.read(), name
    masks = os.path.join("masks", dataset)
    names = sorted(os.listdir(os.path.join(theirs, masks)))
    assert sorted(os.listdir(os.path.join(ours, masks))) == names and names
    for name in names:
        want = cv2.imread(os.path.join(theirs, masks, name),
                          cv2.IMREAD_GRAYSCALE)
        path = os.path.join(ours, masks, name)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                      want)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(decode_mask(f.read()), want)
        assert set(np.unique(want)) <= {0, 255}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A refcoco (unc) root of 4 images at 640 x 480, both tools'
    data_process outputs, both folder2pack outputs from the JAX tool's
    folders, and the packs prewarped by both prewarp tools."""
    tmp = tmp_path_factory.mktemp("prep")
    root = str(tmp / "root")
    chip_smoke.write_refer_root(root, seed=7, splits=COCO_SPLITS, n_images=4)
    mp = pytest.MonkeyPatch()
    try:
        for tool in ("port", "jax"):
            _prepare(mp, root, str(tmp / tool), "refcoco", "unc", tool)
    finally:
        mp.undo()
    img_dir = os.path.join(root, "images", "mscoco", "images", "train2014")
    masks = str(tmp / "jax" / "masks" / "refcoco")
    jax_pack = _jax_tool("folder2pack")
    for split in COCO_SPLITS:
        with open(tmp / "jax" / "anns" / "refcoco" / f"{split}.json") as f:
            items = json.load(f)
        jax_pack.folder2pack(items, img_dir, masks, str(tmp / "jax_pack"),
                             split)
        folder2pack.main(["-j", str(tmp / "jax" / "anns" / "refcoco" /
                                    f"{split}.json"), "-i", img_dir, "-m",
                          masks, "-o", str(tmp / "port_pack")])
    jax_warp = _jax_tool("prewarp")
    for split, keep in (("train", False), ("val", True)):
        src = str(tmp / "port_pack" / f"{split}.refpack")
        jax_warp.prewarp(src, str(tmp / "jax_warp" / f"{split}.refpack"),
                         SIZE, keep)
        prewarp.main(["-i", src, "-o", str(tmp / "port_warp" /
                                           f"{split}.refpack"),
                      "--input-size", str(SIZE)] + (["--keep-ori"] if keep
                                                    else []))
    return {"root": root, "tmp": tmp, "masks": masks}


def test_data_process_refcoco_equals_jax(prepared):
    _assert_same_outputs(str(prepared["tmp"] / "port"),
                         str(prepared["tmp"] / "jax"), "refcoco")
    with open(prepared["tmp"] / "port" / "anns" / "refcoco" / "val.json") as f:
        items = json.load(f)
    assert len(items) == COCO_SPLITS["val"]
    assert {"bbox", "cat", "segment_id", "img_name", "sentences",
            "sentences_num"} == set(items[0])


@pytest.mark.parametrize("dataset, split_by, splits, image_ids", [
    ("refcocog", "umd", {"train": 5, "val": 2, "test": 3}, None),
    ("refcocog", "google", {"train": 5, "val": 3}, None),
    ("refclef", "unc", {"train": 8, "val": 4, "testA": 2, "testB": 2,
                        "testC": 2}, [19579, 17975, 19575, 31, 32]),
    ("refclef", "berkeley", {"train": 6, "val": 3, "test": 3},
     [17975, 40, 41]),
])
def test_data_process_equals_jax(tmp_path, monkeypatch, dataset, split_by,
                                 splits, image_ids):
    """The split lists of each dataset and refclef's skipped images."""
    root = str(tmp_path / "root")
    chip_smoke.write_refer_root(root, seed=11, splits=splits,
                                n_images=len(image_ids or [0] * 3),
                                size=(160, 120), dataset=dataset,
                                split_by=split_by, image_ids=image_ids)
    for tool in ("port", "jax"):
        _prepare(monkeypatch, root, str(tmp_path / tool), dataset, split_by,
                 tool)
    _assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                         dataset)
    names = sorted(os.listdir(tmp_path / "port" / "anns" / dataset))
    want = data_process.dataset_splits(dataset, split_by)
    assert names == sorted(f"{s}.json" for s in want)
    kept = 0
    for name in names:
        with open(tmp_path / "port" / "anns" / dataset / name) as f:
            items = json.load(f)
        kept += len(items)
        assert not {i["img_name"] for i in items} & set(
            data_process.REFCLEF_SKIP if dataset == "refclef" else ())
    refs = jax_refer.REFER(root, dataset, split_by)
    skipped = sum(refs.Imgs[r["image_id"]]["file_name"] in
                  data_process.REFCLEF_SKIP for r in refs.Refs.values())
    assert kept == len(refs.Refs) - (skipped if dataset == "refclef" else 0)
    if dataset == "refclef":
        assert skipped > 0


@pytest.mark.parametrize("split", sorted(COCO_SPLITS))
def test_folder2pack_writes_the_jax_tools_bytes(prepared, split):
    with open(prepared["tmp"] / "port_pack" / f"{split}.refpack", "rb") as a, \
            open(prepared["tmp"] / "jax_pack" / f"{split}.refpack", "rb") as b:
        assert a.read() == b.read()
    reader = RefPackReader(str(prepared["tmp"] / "port_pack" /
                               f"{split}.refpack"))
    assert len(reader) == COCO_SPLITS[split]
    reader.close()


# ------------------------------------------------------------------ LMDB


class _StubTxn:
    def __init__(self, kv):
        self._kv = kv

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key):
        return self._kv.get(key)


class _StubEnv:
    def __init__(self, kv):
        self._kv = kv

    def begin(self, write=False):
        assert write is False
        return _StubTxn(self._kv)


@pytest.fixture()
def stub_lmdb(monkeypatch, prepared):
    """A fake ``lmdb`` module serving the refcoco train pack's records as
    the reference's folder2lmdb writes them (pickle protocol 5, ascii int
    keys, __keys__ / __len__)."""
    reader = RefPackReader(str(prepared["tmp"] / "port_pack" / "train.refpack"))
    records = [reader[i] for i in range(len(reader))]
    reader.close()
    kv = {f"{i}".encode("ascii"): pickle.dumps(r, protocol=5)
          for i, r in enumerate(records)}
    kv[b"__keys__"] = pickle.dumps(list(kv), protocol=5)
    kv[b"__len__"] = pickle.dumps(len(records), protocol=5)
    opened = []

    def open_(path, subdir=None, readonly=None, lock=None, readahead=None,
              meminit=None, **kw):
        assert readonly is True and lock is False
        opened.append(path)
        return _StubEnv(kv)

    module = types.ModuleType("lmdb")
    module.open = open_
    monkeypatch.setitem(sys.modules, "lmdb", module)
    return records, opened


def test_folder2pack_from_lmdb_writes_the_jax_tools_bytes(stub_lmdb,
                                                          tmp_path):
    records, opened = stub_lmdb
    folder2pack.main(["--from-lmdb", "datasets/lmdb/refcoco/train.lmdb",
                      "-o", str(tmp_path / "port")])
    _jax_tool("folder2pack").lmdb2pack("datasets/lmdb/refcoco/train.lmdb",
                                       str(tmp_path / "jax"))
    with open(tmp_path / "port" / "train.refpack", "rb") as a, \
            open(tmp_path / "jax" / "train.refpack", "rb") as b:
        assert a.read() == b.read()
    reader = RefPackReader(str(tmp_path / "port" / "train.refpack"))
    assert [reader[i] for i in range(len(reader))] == records
    reader.close()
    assert opened and set(opened) == {"datasets/lmdb/refcoco/train.lmdb"}


def test_open_backend_reads_lmdb_through_the_stub(stub_lmdb, prepared):
    records, opened = stub_lmdb
    backend = open_backend("stub/train.lmdb")
    assert isinstance(backend, lmdb_backend.LmdbBackend) and not opened
    assert len(backend) == len(records) and opened == ["stub/train.lmdb"]
    assert [backend[i] for i in range(len(backend))] == records
    lmdb_ds = RefDataset("stub/train.lmdb", prepared["masks"], "refcoco",
                         "train", "val", SIZE, 17)
    pack_ds = RefDataset(str(prepared["tmp"] / "port_pack" / "train.refpack"),
                         prepared["masks"], "refcoco", "train", "val", SIZE,
                         17)
    for a, b in zip(lmdb_ds.get_batch([0, 3]), pack_ds.get_batch([0, 3])):
        _assert_equal_samples(a, b)


def test_open_backend_without_lmdb_names_lmdb_and_refpack(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb fails
    with pytest.raises(ValueError, match="LMDB") as info:
        open_backend("datasets/lmdb/refcoco/val.lmdb")
    assert ".refpack" in str(info.value) and "--from-lmdb" in str(info.value)


def test_lmdb_loads_falls_back_to_pyarrow(monkeypatch):
    seen = {}
    module = types.ModuleType("pyarrow")
    module.deserialize = lambda buf: seen.setdefault("buf", bytes(buf))
    monkeypatch.setitem(sys.modules, "pyarrow", module)
    legacy = b"\x00\x00\x00\x00not-a-pickle"
    assert lmdb_backend._loads(legacy) == legacy == seen["buf"]
    assert lmdb_backend._loads(pickle.dumps({"a": 1})) == {"a": 1}


# --------------------------------------------------------------- prewarp


def _records(path):
    reader = RefPackReader(str(path))
    out = [reader[i] for i in range(len(reader))]
    reader.close()
    return out


@pytest.mark.parametrize("split", ["train", "val"])
def test_prewarp_records_within_the_bars_of_the_jax_tools(prepared, split):
    """inverse, ori_size, the metadata and the original bytes exactly;
    the warped image within one uint8 level and the warped mask within
    1 / 255 (the JAX tool warps with OpenCV, the port with numpy)."""
    ours = _records(prepared["tmp"] / "port_warp" / f"{split}.refpack")
    theirs = _records(prepared["tmp"] / "jax_warp" / f"{split}.refpack")
    assert len(ours) == len(theirs) == COCO_SPLITS[split]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) and ("img" in a) == (split == "val")
        for key in set(a) - {"warped", "warped_mask"}:
            assert a[key] == b[key], key
        wa = np.frombuffer(a["warped"], np.uint8).astype(int)
        wb = np.frombuffer(b["warped"], np.uint8).astype(int)
        assert wa.size == wb.size == SIZE * SIZE * 3
        assert np.abs(wa - wb).max() <= 1
        ma = np.frombuffer(a["warped_mask"], np.float32)
        mb = np.frombuffer(b["warped_mask"], np.float32)
        assert ma.size == mb.size == SIZE * SIZE
        assert np.abs(ma - mb).max() <= 1.0 / 255


def _assert_equal_samples(a, b):
    assert set(a) == set(b)
    for key, value in b.items():
        if isinstance(value, np.ndarray):
            assert a[key].dtype == value.dtype, key
            np.testing.assert_array_equal(a[key], value, err_msg=key)
        else:
            assert a[key] == value, key


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_prewarped_pack_gives_the_live_paths_samples(prepared, mode):
    """RefDataset over the port's prewarped pack against RefDataset over
    the raw pack, bit for bit: per sample, and in train and val through
    get_batch, where the raw pack goes through the native data plane."""
    split = "train" if mode == "train" else "val"
    args = (prepared["masks"], "refcoco", split, mode, SIZE, 17)
    warped = RefDataset(str(prepared["tmp"] / "port_warp" /
                            f"{split}.refpack"), *args)
    raw = RefDataset(str(prepared["tmp"] / "port_pack" / f"{split}.refpack"),
                     *args)
    n = COCO_SPLITS[split]
    for i in range(n):
        _assert_equal_samples(
            warped.__getitem__(i, rng=np.random.RandomState(i)),
            raw.__getitem__(i, rng=np.random.RandomState(i)))
    idx = list(range(n))[::-1]
    for a, b in zip(warped.get_batch(idx, [np.random.RandomState(i)
                                           for i in idx]),
                    raw.get_batch(idx, [np.random.RandomState(i)
                                        for i in idx])):
        _assert_equal_samples(a, b)


def test_first_train_batch_prewarped_equals_raw_through_the_plane(prepared):
    """Phase 19(c) at this size: the loaders' first train batch."""
    first, calls = {}, []
    with chip_smoke.plane_calls() as calls:
        for name in ("port_warp", "port_pack"):
            data = RefDataset(str(prepared["tmp"] / name / "train.refpack"),
                              prepared["masks"], "refcoco", "train", "train",
                              SIZE, 17)
            loader = RefDataLoader(data, batch_size=4, shuffle=True, seed=0,
                                   drop_last=True, num_workers=1)
            loader.set_epoch(1)
            first[name] = next(iter(loader))
    assert calls == [4]
    assert set(first["port_warp"]) == set(first["port_pack"])
    for key, value in first["port_pack"].items():
        np.testing.assert_array_equal(first["port_warp"][key], value)


# ------------------------------------------------- the entries as processes


def test_entries_run_as_modules_and_report_refs_per_s(tmp_path):
    """python3 -m of each entry on a small root, as phase 19(b) runs them:
    each prints its progress lines and a final rate line."""
    root, prep = str(tmp_path / "root"), str(tmp_path / "prep")
    splits = {"train": 4, "val": 2, "testA": 1, "testB": 1}
    chip_smoke.write_refer_root(root, seed=5, splits=splits, n_images=3,
                                size=(160, 120))
    py, cwd = sys.executable, os.getcwd()
    os.chdir(REPO)
    try:
        outs = {"data_process": chip_smoke._run_entries([[
            py, "-m", "cris_tpu_torch.data_process", "--data_root", root,
            "--output_dir", prep, "--dataset", "refcoco", "--split", "unc",
            "--generate_mask"]])}
        outs["folder2pack"] = chip_smoke._run_entries([[
            py, "-m", "cris_tpu_torch.folder2pack", "-j",
            os.path.join(prep, "anns", "refcoco", f"{s}.json"), "-i",
            os.path.join(root, "images", "mscoco", "images", "train2014"),
            "-m", os.path.join(prep, "masks", "refcoco"), "-o",
            os.path.join(prep, "pack")] for s in splits])
        outs["prewarp"] = chip_smoke._run_entries([[
            py, "-m", "cris_tpu_torch.prewarp", "-i",
            os.path.join(prep, "pack", "val.refpack"), "-o",
            os.path.join(prep, "warped", "val.refpack"), "--input-size",
            "64", "--keep-ori"]])
    finally:
        os.chdir(cwd)
    rates = {k: chip_smoke._stage_rate(v) for k, v in outs.items()}
    assert rates["data_process"]["refs"] == sum(splits.values())
    assert rates["folder2pack"]["refs"] == sum(splits.values())
    assert rates["prewarp"]["refs"] == splits["val"]
    assert all(r["refs_per_s"] > 0 for r in rates.values())
    assert len(_records(os.path.join(prep, "warped", "val.refpack"))) == 2
