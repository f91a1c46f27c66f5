"""The port's config reader (``cris_tpu_torch/utils/yaml_subset.py``)
against PyYAML: every config file under ``config/`` reads to what
``yaml.safe_load`` gives and flattens to what the JAX package's loader
gives; each scalar and line form of the subset reads to PyYAML's value
(YAML 1.1's resolver: ``1e-4`` is a string, ``010`` is 8), and every
other construct is refused by name; without PyYAML (the card's machine)
every config reads through ``cli.get_parser`` and the tiny train entry
runs to its end."""

import json
import math
import os
import subprocess
import sys

import pytest
import yaml

from cris_tpu.utils.config import load_cfg_from_cfg_file as jax_load
from cris_tpu_torch.cli import get_parser
from cris_tpu_torch.utils import load_cfg_from_cfg_file
from cris_tpu_torch.utils.yaml_subset import load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f"config/{d}/{n}" for d in os.listdir(os.path.join(REPO, "config"))
                 for n in os.listdir(os.path.join(REPO, "config", d)))
EXPECTED = os.path.join(REPO, "tests", "torch_config_fixtures", "expected.json")


def _same(a, b, ordered=True):
    """Equal values of the same types, all the way down (NaN equal to
    NaN; a mapping's keys in the same order when ``ordered``)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        keys_a, keys_b = (list(a), list(b)) if ordered else (sorted(a), sorted(b))
        return keys_a == keys_b and all(_same(a[k], b[k], ordered) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y, ordered) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_there_are_nine_configs():
    assert len(CONFIGS) == 9, CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_reads_as_safe_load(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert _same(load(text, path), yaml.safe_load(text))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_flattens_as_the_jax_loader(path):
    got = load_cfg_from_cfg_file(os.path.join(REPO, path))
    want = jax_load(os.path.join(REPO, path))
    assert _same(dict(got), dict(want))


def test_expected_json_is_what_safe_load_gives():
    """The expectation chip_smoke.py holds the card's reading to is
    PyYAML's reading of the files as they are."""
    with open(EXPECTED) as f:
        expected = json.load(f)["configs"]
    assert sorted(expected) == CONFIGS
    for path in CONFIGS:
        with open(os.path.join(REPO, path)) as f:
            raw = yaml.safe_load(f)
        flat = {}
        for section in raw:
            flat.update(raw[section])
        assert _same(expected[path], flat, ordered=False), path


# value forms read to PyYAML's value, each as a second-level and a
# top-level value
EQUAL_FORMS = [
    "1e-4", "1.0e-4", "1.0e+4", "1.0e4", "0.", "0.0001", ".5", "-.5", "+.5",
    "3.", "1.5_0", "+1.5e-3", "1e5", "1_000", "1__0", "0_7", "0x1F", "-0x1f",
    "0xFFFF_FFFF", "010", "08", "0o17", "0b101", "1:20", "-1:20", "1:20.5",
    "1:60", ".inf", "-.inf", ".NaN", "~", "null", "Null", "NULL", "nUll", "",
    "yes", "Yes", "YES", "yEs", "no", "on", "off", "y", "n", "true", "False",
    "TRUE", "tRue", "-1", "+1", "-0", "0", "12abc", "'nccl'", "'it''s'",
    "'#x'", "'a'  # c", '"a\\tb"', '"\\x41\\u00e9"', '"q\\"q"', "a#b", "a #b",
    "a  b", "x y z # c", "a:b", ":x", "-x", "?x", "tcp://localhost:3681",
    "pretrain/RN50.pt", "synthetic://16?seed=2", "[512, 1024, 1024]", "[]",
    "[1, 2,]", "[a b, 'c', \"d\"]", "[1.5, yes, ~, 0x10]", "[a#b]", "[a:b]",
    "[1] # c", "0b", "0x",
]


@pytest.mark.parametrize("form", EQUAL_FORMS)
def test_value_form_reads_as_safe_load(form):
    for text in (f"S:\n  k: {form}\n", f"k: {form}\n"):
        assert _same(load(text), yaml.safe_load(text)), text


# forms refused, with the construct the refusal names
REFUSED_FORMS = {
    "&a 1": "an anchor", "*a": "an alias", "!!str 1": "a tag",
    "!foo x": "a tag", "|": "a block scalar", ">": "a block scalar",
    "{a: 1}": "a flow mapping", "[[1]]": "a nested flow list",
    "[{a: 1}]": "a flow mapping", "[a: 1]": "a flow mapping in a flow list",
    "- 1": "a block sequence", "-": "a block sequence", "? x": "a complex key",
    "'a' b": "text after a quoted scalar", "[1, 2": "a flow list over several lines",
    "a: b": "a mapping inside a value", "%x": "a directive", "@x": "a reserved '@'",
    "`x": "a reserved '`'", "[1,,2]": "an empty entry in a flow list",
    '"\\q"': "the escape", "'unterminated": "a quoted scalar over several lines",
    "2001-12-14": "the timestamp", "<<": "a merge key", "=": "a value key",
    "0b_": "the integer", "a\tb": "a tab",
}


@pytest.mark.parametrize("form", sorted(REFUSED_FORMS))
def test_value_form_outside_the_subset_is_refused_by_name(form):
    for number, text in ((2, f"S:\n  k: {form}\n"), (1, f"k: {form}\n")):
        with pytest.raises(ValueError, match=f"^x.yaml:{number}: "
                           f"{REFUSED_FORMS[form]}"):
            load(text, "x.yaml")


# documents refused, with the line and the construct named
REFUSED_DOCS = {
    "anchor on a section": ("S: &x\n  a: 1\n", 1, "an anchor"),
    "alias": ("S:\n  a: 1\n  b: *x\n", 3, "an alias"),
    "tag": ("S:\n  a: !!float 1\n", 2, "a tag"),
    "block scalar": ("S:\n  a: |\n    text\n", 2, "a block scalar"),
    "document start": ("---\nS:\n  a: 1\n", 1, "a document marker"),
    "document end": ("S:\n  a: 1\n...\n", 3, "a document marker"),
    "flow mapping": ("S:\n  a: {b: 1}\n", 2, "a flow mapping"),
    "nested flow list": ("S:\n  a: [1, [2]]\n", 2, "a nested flow list"),
    "block sequence": ("S:\n  - 1\n", 2, "a block sequence"),
    "tab indentation": ("S:\n\ta: 1\n", 2, "a tab in the indentation"),
    "third level": ("S:\n  a:\n    b: 1\n", 3, "a third level of nesting"),
    "multi-line scalar": ("S:\n  a: x\n    y\n", 3, "a multi-line scalar"),
    "indented top level": ("  S:\n    a: 1\n", 1, "an indented top-level key"),
    "uneven indentation": ("S:\n    a: 1\n  b: 2\n", 3, "a key indented unlike"),
    "not a key": ("S:\n  a:1\n", 2, "a line that is not 'key: value'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_DOCS))
def test_document_outside_the_subset_is_refused_by_name(case):
    text, line, construct = REFUSED_DOCS[case]
    with pytest.raises(ValueError, match=f"^x.yaml:{line}: {construct}"):
        load(text, "x.yaml")


# documents the reader takes, against PyYAML
EQUAL_DOCS = {
    "a repeated key keeps its last value": "S:\n  a: 1\n  a: 2\n",
    "a repeated section keeps its last mapping": "S:\n  a: 1\nS:\n  b: 2\n",
    "an empty section is None": "S:\nT:\n  a: 1\n",
    "comments everywhere": "# top\nS:   # sec\n  # inner\n  a: 1 # c\n\n"
                           "  b: 'x # y' # z\n",
    "sections indented differently": "S:\n    a: 1\nT:\n  b: 2\n",
    "CRLF line ends": "S:\r\n  a: 1\r\n",
    "top-level scalars": "a: 1\nb: [1]\n",
    "a key with a colon": "S:\n  a:b: 1\n",
    "a quoted key": "S:\n  'a b': 1\n",
    "typed keys": "S:\n  1: x\n  yes: y\n",
    "an empty document": "",
    "a document of comments": "# x\n",
    "a byte-order mark": "\ufeffS:\n  a: 1\n",
}


@pytest.mark.parametrize("case", sorted(EQUAL_DOCS))
def test_document_reads_as_safe_load(case):
    text = EQUAL_DOCS[case]
    assert _same(load(text), yaml.safe_load(text))


def test_get_parser_reads_a_g_ref_config():
    cfg = get_parser(argv=["--config", os.path.join(REPO, "config", "refcocog_u",
                                                    "cris_r50.yaml"),
                           "--device", "cpu", "--opts", "TRAIN.batch_size", "16"])
    assert (cfg.word_len, cfg.batch_size, cfg.dist_backend, cfg.profile_dir,
            cfg.weight_decay) == (22, 16, "nccl", None, 0.0)


_NO_YAML = "import sys\nsys.modules['yaml'] = None\n"


def test_every_config_reads_without_pyyaml():
    """With yaml hidden, get_parser reads each of the nine files to the
    committed expectation (and the port's modules never import it)."""
    code = _NO_YAML + (
        "import json\n"
        "from cris_tpu_torch.cli import get_parser\n"
        f"expected = json.load(open({EXPECTED!r}))['configs']\n"
        "for path, want in expected.items():\n"
        f"    cfg = get_parser(argv=['--config', {REPO!r} + '/' + path])\n"
        "    got = {k: v for k, v in cfg.items() if k != 'device'}\n"
        "    assert got == want and all(type(got[k]) is type(want[k]) "
        "for k in want), path\n"
        "print(len(expected))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "9"


def test_tiny_train_entry_runs_without_pyyaml(tmp_path):
    """python3 -m cris_tpu_torch.train on cris_tiny.yaml, one epoch on the
    CPU, with yaml hidden: to its end and its run line."""
    code = _NO_YAML + (
        "import runpy\n"
        "sys.argv = ['train', '--config', "
        f"{os.path.join(REPO, 'config', 'synthetic', 'cris_tiny.yaml')!r}, "
        "'--device', 'cpu', '--opts', 'TRAIN.epochs', '1']\n"
        "runpy.run_module('cris_tpu_torch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    run = [line for line in (out.stdout + out.stderr).splitlines()
           if "=> run:" in line]
    assert run and json.loads(run[-1].split("=> run: ", 1)[1])["steps"] == 8
