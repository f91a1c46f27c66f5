"""The port's int8 error audit (``models.auditing``, python3 -m
cris_tpu_torch.int8_error_audit) against the JAX package's
``CRIS_INT8_AUDIT`` hook on the CPU, on tests/test_torch_int8.py's tiny
int8 CRIS (scanned stage tails, gates 16 / 32 / 32) in f32 compute.

- per site, the four statistics (max |err|, rms(err), max |ref|,
  rms(ref)) against the JAX "quant_audit" collection mapped through
  ``site_path`` / ``sites_of``, with static (JAX's maxabs) and dynamic
  scales, local and compound: the same set of sites; bars below;
- under ``local`` the logits are those of the model with its int8 sites
  off, bit for bit; under ``compound`` those of the int8 model;
- the entry's ``main`` on the CPU prints every site once, worst rms
  first, and the summary line; no engaged site exits non-zero.

Bars: the reference statistics within 1e-5 relative (the two packages'
plain convs on inputs equal to f32 rounding). With static scales the
error statistics within 1e-3 relative of the larger plus 1e-6 of the
site's max |ref|: the int8 levels are the same in both packages
(tests/test_torch_int8.py counts 0 flipped), so err differs only by the
rounding of its two terms (measured: 3.8e-5 at worst). With dynamic
scales 1e-2: each package takes its own max |x| / 127, and one rounding
of it moves every level boundary of the site (measured: neck/f3_cat at
2.8e-3 in rms(err) under local, every other site within 6e-5).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu_torch import int8_error_audit
from cris_tpu_torch.checkpoint import quant_from_jax, set_act_scales
from cris_tpu_torch.checkpoint.from_jax import sites_of
from cris_tpu_torch.models import auditing, int8_sites
from test_torch_int8 import (_one_torch_thread, _t, jax_env,  # noqa: F401
                             jax_maxabs, tiny)

REF_RTOL = 1e-5
ERR_RTOL = {True: 1e-3, False: 1e-2}  # by static
ERR_ATOL = 1e-6  # in units of max |ref|


def _jax_audit(tiny, scales, mode, env):
    """JAX's per-site stats {port site name: (4,)} and logits."""
    env.setenv("CRIS_INT8_AUDIT", mode)
    model = dataclasses.replace(tiny["model"], fold_bn=True, pos_grid=2,
                                quant_int8=True)
    variables = dict(tiny["folded"])
    if scales is not None:
        variables["quant"] = scales
    pred, mutated = jax.jit(lambda v, i, w: model.apply(
        v, i, w, train=False, mutable=["quant_audit"]))(
        variables, jnp.asarray(tiny["img"]), jnp.asarray(tiny["word"]))
    env.delenv("CRIS_INT8_AUDIT")
    out = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if key == "err_stats":
                out.update(sites_of("/".join(prefix), np.asarray(value)))
            else:
                walk(value, prefix + (key,))
    walk(jax.tree_util.tree_map(np.asarray, mutated["quant_audit"]), ())
    return out, np.asarray(pred)


def _port_run(port, tiny, mode=None):
    """(stats {site name: (4,)} or None, logits NHWC) of one f32 forward,
    under ``auditing(mode)`` when a mode is given."""
    img = _t(tiny["img"]).permute(0, 3, 1, 2)
    word = _t(tiny["word"]).long()
    with torch.no_grad(), (auditing(mode) if mode
                           else contextlib.nullcontext()) as record:
        pred = port(img, word).permute(0, 2, 3, 1).numpy()
    if record is None:
        return None, pred
    names = {m: n for n, m in int8_sites(port).items()}
    return {names[m]: s.numpy() for m, s in record.stats.items()}, pred


@contextlib.contextmanager
def _scales(port, scales):
    set_act_scales(port, scales)
    try:
        yield port
    finally:
        set_act_scales(port, {})


@pytest.mark.parametrize("mode", ["local", "compound"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_site_statistics_match_the_jax_hook(tiny, jax_env, jax_maxabs,
                                            static, mode):
    scales = jax_maxabs if static else None
    want, _ = _jax_audit(tiny, scales, mode, jax_env)
    with _scales(tiny["port"], quant_from_jax(scales) if static else {}):
        got, _ = _port_run(tiny["port"], tiny, mode)
    assert set(got) == set(want)
    assert len(got) >= (25 if static else 10)
    worst = [0.0, 0.0]
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(g[2:], w[2:], rtol=REF_RTOL, err_msg=name)
        tol = ERR_RTOL[static] * np.maximum(g[:2], w[:2]) + ERR_ATOL * w[2]
        assert (np.abs(g[:2] - w[:2]) <= tol).all(), (name, g, w)
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
        worst = [max(worst[0], rel[:2].max()), max(worst[1], rel[2:].max())]
    print(f"audit {'static' if static else 'dynamic'} {mode}: {len(got)} "
          f"sites, worst relative gap err {worst[0]:.3e}, ref {worst[1]:.3e}")


def test_local_feeds_plain_and_compound_feeds_int8(tiny, jax_maxabs):
    """local: the logits of the model with every int8 site off, bit for
    bit; compound: those of the int8 model without the audit."""
    port = tiny["port"]
    sites = int8_sites(port)
    with _scales(port, quant_from_jax(jax_maxabs)):
        _, local = _port_run(port, tiny, "local")
        _, compound = _port_run(port, tiny, "compound")
        _, int8 = _port_run(port, tiny)
    gates = {name: mod.quant for name, mod in sites.items()}
    for mod in sites.values():
        mod.quant = None
    try:
        _, plain = _port_run(port, tiny)
    finally:
        for name, mod in sites.items():
            mod.quant = gates[name]
    assert np.array_equal(local, plain)
    assert np.array_equal(compound, int8)
    assert not np.array_equal(int8, plain)


def _main(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = int8_error_audit.main(
            ["--preset", "TINY", "--size", "64", "--batch", "2",
             "--n-batches", "1", "--device", "cpu", *args])
    return result, buf.getvalue()


@pytest.mark.parametrize("args", [["--min-ch", "16"],
                                  ["--min-ch", "16", "--static", "--mode",
                                   "compound"]], ids=["dynamic", "static"])
def test_main_prints_every_site_sorted(args):
    result, text = _main(*args)
    rows = result["rows"]
    lines = text.splitlines()
    start = lines.index(next(x for x in lines if x.startswith("site ")))
    printed = [x.split() for x in lines[start + 1:start + 1 + len(rows)]]
    assert [p[0] for p in printed] == [r[0] for r in rows]
    assert len({r[0] for r in rows}) == len(rows) == result["sites"] > 0
    rms = [float(p[2]) for p in printed]
    assert rms == sorted(rms, reverse=True)
    assert f"{len(rows)} quantized sites; worst rms {rows[0][2]:.4f}" in text
    if "--static" in args:
        assert 0.5 <= result["agreement"] <= 1.0
        assert "mask agreement vs bf16 at threshold 0.35 (compound)" in text
    else:
        assert result["agreement"] is None
    print(text)


def test_main_exits_when_no_site_engaged():
    with pytest.raises(SystemExit) as info:
        _main("--min-ch", "100000")
    assert info.value.code not in (0, None)
