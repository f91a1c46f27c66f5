"""python3 -m cris_tpu_torch.parity_report against the JAX package's
tools/parity_report.py on the CPU, on tests/test_torch_eval.py's shared
setup: tiny CRIS with the JAX init's weights as a best_model.pth, a
RefPack of the JAX make_record's records and their GT masks.

- both tools' ``--json`` rows on the same ``.pth`` and pack (f32): the
  same keys and split, the IoU and oIoU within 0.5 points (that file's
  bar for the test entry against the JAX Evaluator);
- ``EXPECTED`` equals the JAX tool's table, and so do its splits;
- a published number patched into ``EXPECTED`` drives PASS (exit 0) at a
  wide tolerance and FAIL (exit 1) at tolerance 0 in both tools;
- an orbax directory as ``--ckpt`` is refused.
"""

import importlib.util
import json
import os

import pytest

from cris_tpu_torch import parity_report
from test_torch_eval import _quiet_logger, setup  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
BAR = 0.5  # IoU points


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_report", os.path.join(REPO, "tools", "parity_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reports(setup, tmp_path_factory):  # noqa: F811 (the imported fixture)
    """Both tools' exit codes and JSON reports, first with no published
    number for the split, then with one patched in: (PASS at tolerance
    100, FAIL at tolerance 0)."""
    work = tmp_path_factory.mktemp("parity")
    config = work / "cris_tiny_fp32.yaml"
    with open(TINY) as f:
        text = f.read()
    assert "precision: bf16" in text
    config.write_text(text.replace("precision: bf16", "precision: fp32"))
    os.symlink(setup["pack"], work / "val.refpack")
    ckpt = str(setup["root"] / "exp" / "CRIS_TINY" / "best_model.pth")
    jax_tool = _jax_tool()
    tools = {"port": (parity_report, ["--device", "cpu"]),
             "jax": (jax_tool, [])}
    key = ("synthetic", "val", parity_report.backbone_name(setup["cfg"]))
    out = {}
    for name, (tool, extra) in tools.items():
        runs = []
        for expected, tolerance in ((None, 0.1), (50.0, 100.0),
                                    (50.0, 0.0)):
            path = str(work / f"{name}_{tolerance}.json")
            saved = dict(tool.EXPECTED)
            if expected is not None:
                tool.EXPECTED[key] = expected
            try:
                code = tool.main([
                    "--config", str(config), "--ckpt", ckpt,
                    "--splits", "val", "--lmdb-root", str(work),
                    "--mask-root", setup["masks"], "--tolerance",
                    str(tolerance), "--json", path, *extra])
            finally:
                tool.EXPECTED.clear()
                tool.EXPECTED.update(saved)
            with open(path) as f:
                runs.append((code, json.load(f)))
        out[name] = runs
    out["jax_tool"] = jax_tool
    return out


def test_rows_match_the_jax_tool(reports):
    """One row, the val split at val-test's table, no published number:
    exit 0 in both; IoU and oIoU within 0.5 points, the Pr@ columns
    present in both."""
    (port_code, port), (jax_code, jax) = (reports["port"][0],
                                          reports["jax"][0])
    assert port_code == jax_code == 0
    assert port["all_ok"] and jax["all_ok"]
    (row,), (jrow,) = port["rows"], jax["rows"]
    print(f"parity report: port IoU {row['iou']!r}, JAX {jrow['iou']!r}; "
          f"oIoU {row['oIoU']!r} vs {jrow['oIoU']!r}")
    assert sorted(row) == sorted(jrow)
    for k in ("dataset", "split", "backbone", "expected_iou", "diff"):
        assert row[k] == jrow[k], k
    assert abs(row["iou"] - jrow["iou"]) <= BAR
    assert abs(row["oIoU"] - jrow["oIoU"]) <= BAR
    assert 0.0 <= row["iou"] <= 100.0


def test_patched_expected_passes_and_fails_in_both(reports):
    """50.0 patched in for the split: within tolerance 100 PASS (exit 0,
    all_ok), at tolerance 0 FAIL (exit 1), in both tools, each row's diff
    its IoU less 50."""
    for name in ("port", "jax"):
        (_, _), (pass_code, passed), (fail_code, failed) = reports[name]
        assert (pass_code, passed["all_ok"]) == (0, True), name
        assert (fail_code, failed["all_ok"]) == (1, False), name
        for report in (passed, failed):
            (row,) = report["rows"]
            assert row["expected_iou"] == 50.0
            assert abs(row["diff"] - (row["iou"] - 50.0)) <= 1e-9


def test_expected_table_and_splits_are_the_jax_tools(reports):
    tool = reports["jax_tool"]
    assert parity_report.EXPECTED == tool.EXPECTED
    assert parity_report.DEFAULT_SPLITS == tool.DEFAULT_SPLITS


def test_an_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        parity_report.main(["--config", TINY, "--ckpt", str(tmp_path),
                            "--device", "cpu"])
