"""The PyTorch port's model against the JAX reference, on the CPU in f32.

The JAX tiny CRIS is initialised with PRNGKey(42) on the inputs of
tests/goldens/tiny_forward.npz, converted with cris_tpu_torch's
``from_jax``, and every module of the eval forward is compared on the
same inputs at rtol = atol = 1e-4 (the tests/test_golden.py:40 bar): the
two runs differ only in the order of f32 sums.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris

from cris_tpu_torch.checkpoint import from_jax, load_jax_variables
from cris_tpu_torch.models import CLIPConfig, CRIS, build_segmenter

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "tiny_forward.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


def _port_tiny():
    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    return CRIS(ccfg, fpn_in=(128, 256, 64), fpn_out=(32, 64, 128),
                vis_dim=64, num_layers=2, num_head=4, dim_ffn=128,
                dropout=0.0).eval()


@pytest.fixture(scope="module")
def pair():
    data = np.load(GOLDEN)
    model = tiny_cris(dropout=0.0, dtype=None)
    variables = model.init(jax.random.PRNGKey(42), jnp.asarray(data["img"]),
                           jnp.asarray(data["word"]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = load_jax_variables(_port_tiny(), variables)
    return data, model, variables, port


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax(model, variables, fn, *args):
    return model.apply(variables, *[jnp.asarray(a) for a in args], method=fn)


def test_visual_matches_jax(pair):
    data, model, variables, port = pair
    ref = _jax(model, variables, lambda m, x: m.backbone.encode_image(x, False),
               data["img"])
    with torch.no_grad():
        got = port.backbone.encode_image(_nchw(data["img"]))
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


def test_text_matches_jax(pair):
    data, model, variables, port = pair
    word, state = _jax(model, variables, lambda m, w: m.backbone.encode_text(w),
                       data["word"])
    with torch.no_grad():
        pw, ps = port.backbone.encode_text(torch.from_numpy(data["word"]).long())
    np.testing.assert_allclose(pw.numpy(), np.asarray(word), **TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(state), **TOL)


def _jax_features(model, variables, data):
    def feats(m, img, word):
        vis = m.backbone.encode_image(img, False)
        word_feats, state = m.backbone.encode_text(word)
        fq = m.neck(vis, state, False)
        dec = m.decoder(fq, word_feats, word == 0, False)
        return vis, word_feats, state, fq, dec

    return _jax(model, variables, feats, data["img"], data["word"])


def test_neck_matches_jax(pair):
    data, model, variables, port = pair
    vis, _, state, fq, _ = _jax_features(model, variables, data)
    with torch.no_grad():
        got = port.neck(tuple(_nchw(v) for v in vis),
                        torch.from_numpy(np.array(state)))
    np.testing.assert_allclose(_nhwc(got), np.asarray(fq), **TOL)


def test_decoder_matches_jax(pair):
    data, model, variables, port = pair
    _, word_feats, _, fq, dec = _jax_features(model, variables, data)
    pad = torch.from_numpy(data["word"] == 0)
    with torch.no_grad():
        got = port.decoder(_nchw(fq), torch.from_numpy(np.array(word_feats)),
                           pad)
    np.testing.assert_allclose(_nhwc(got), np.asarray(dec), **TOL)


def test_projector_matches_jax(pair):
    data, model, variables, port = pair
    _, _, state, _, dec = _jax_features(model, variables, data)
    ref = _jax(model, variables, lambda m, x, s: m.proj(x, s, False),
               np.asarray(dec), np.asarray(state))
    with torch.no_grad():
        got = port.proj(_nchw(dec), torch.from_numpy(np.array(state)))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_forward_matches_golden(pair):
    data, _, _, port = pair
    with torch.no_grad():
        pred = port(_nchw(data["img"]), torch.from_numpy(data["word"]).long())
    assert pred.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(_nhwc(pred), data["pred"], **TOL)


def test_state_dict_round_trip(pair):
    """port state_dict -> convert_cris_state_dict -> from_jax is exact."""
    from cris_tpu.checkpoint.torch_convert import convert_cris_state_dict

    *_, port = pair
    sd = port.state_dict()
    variables, _ = convert_cris_state_dict(sd, num_decoder_layers=2)
    back = from_jax(variables)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)


def test_from_jax_covers_every_key(pair):
    _, _, variables, port = pair
    sd = from_jax(variables)
    ref = port.state_dict()
    assert set(sd) == set(ref)
    for key, value in ref.items():
        assert sd[key].shape == tuple(value.shape), key


def test_r50_parameter_shapes_match_jax():
    """CRIS-R50 at full width: the port built on the meta device has the
    JAX init's parameter shapes. Parameter shapes do not depend on the
    input size, so the abstract JAX init runs on a 64 px image."""
    from cris_tpu.models import build_segmenter as jax_build
    from cris_tpu_torch.utils import cris_r50_refcoco

    cfg = cris_r50_refcoco()
    cfg.precision = "fp32"
    jmodel = jax_build(cfg)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, cfg.word_len), jnp.int32))
    # zero-stride stand-ins: from_jax reshapes views and allocates ~nothing
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    want = {k: v.shape for k, v in from_jax(leaves).items()}
    port = build_segmenter(cfg, device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) > 50_000_000


def test_seeded_init_is_deterministic():
    from cris_tpu_torch.utils import CfgNode

    cfg = CfgNode(dict(clip_pretrain="TINY", fpn_in=[128, 256, 64],
                       fpn_out=[32, 64, 128], vis_dim=64, num_layers=2,
                       num_head=4, dim_ffn=128, dropout=0.0))
    a = build_segmenter(cfg, device="cpu", seed=3).state_dict()
    b = build_segmenter(cfg, device="cpu", seed=3).state_dict()
    c = build_segmenter(cfg, device="cpu", seed=4).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a["proj.txt.weight"], c["proj.txt.weight"])


def test_build_segmenter_defaults_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU; build_segmenter once defaulted to the CPU."""
    import inspect

    sig = inspect.signature(build_segmenter)
    assert sig.parameters["device"].default == "cuda"
    for switch in ("fold_bn", "fused_bottleneck", "fused_stem"):
        assert sig.parameters[switch].default is False


def test_config_preset_equals_yaml():
    from cris_tpu_torch.utils import cris_r50_refcoco, load_cfg_from_cfg_file

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    loaded = load_cfg_from_cfg_file(
        os.path.join(repo, "config", "refcoco", "cris_r50.yaml"))
    assert dict(cris_r50_refcoco()) == dict(loaded)


@pytest.mark.parametrize("method,align,src,dst", [
    ("bicubic", False, 7, 13),   # attnpool pos-embed grid at 416 px
    ("bicubic", True, 26, 64),   # eval probabilities to the input size
    ("bilinear", False, 13, 26),  # FPN / projector upsample
])
def test_resize_matches_jax(method, align, src, dst):
    from cris_tpu.ops.resize import resize2d as jax_resize
    from cris_tpu_torch.ops.resize import resize2d

    x = np.random.RandomState(src).randn(2, src, src, 3).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), (dst, dst), method, align_corners=align)
    got = resize2d(_nchw(x), (dst, dst), method, align_corners=align)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dynamic_conv_and_posenc_match_jax():
    from cris_tpu.ops.dynamic_conv import dynamic_conv2d as jax_dynconv
    from cris_tpu.ops.posenc import sincos_1d as j1, sincos_2d as j2
    from cris_tpu_torch.ops import dynamic_conv2d, sincos_1d, sincos_2d

    rng = np.random.RandomState(5)
    x = rng.randn(3, 12, 10, 8).astype(np.float32)
    w = rng.randn(3, 8, 3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    ref = jax_dynconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 3)
    got = dynamic_conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), 3)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sincos_2d(64, 26, 26), j2(64, 26, 26))
    np.testing.assert_array_equal(sincos_1d(64, 17), j1(64, 17))
