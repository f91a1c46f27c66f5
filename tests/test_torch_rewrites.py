"""The port's exact bf16 graph rewrites against the JAX package's, on the
CPU in f32 (ROADMAP §1 item 11):

- ``ops/s2d`` (space-to-depth and the stem's kernel rearrangements and
  convs) and ``ops/upsample_conv`` (the folded kernels, the phase
  kernels, the transposed-conv up-core, the phase convs of the int8
  sites and the border corrections) against their
  JAX functions at 1e-5 relative;
- the layers: ``QuantConv.pooled`` (``PooledConv1x1``), ``s2d_pooled``
  (``S2dPooledConv1x1``), ``s2d3x3`` (``S2dConv3x3``), ``UpConvBNReLU``
  and ``CatUpConvBNReLU`` at 1e-5;
- the tiny CRIS with all three rewrites on against the JAX model with
  ``fuse_pool=True``, ``CRIS_S2D_STEM=1`` and ``CRIS_FUSE_UPSAMPLE=1``,
  unfolded and BN-folded, at 1e-4 (tests/test_torch_model.py's bar); and
  the port's rewritten model against its own reference-order one, in
  eval and in training (the s2d stem's BN statistics over the phases).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris

from cris_tpu.checkpoint import fold_batchnorm as jax_fold
from cris_tpu.models import layers as jl
from cris_tpu.ops import s2d as js
from cris_tpu.ops import upsample_conv as ju
from cris_tpu_torch.checkpoint import fold_batchnorm, from_jax
from cris_tpu_torch.models import CLIPConfig, CRIS
from cris_tpu_torch.models import layers as pl
from cris_tpu_torch.ops import s2d as ps
from cris_tpu_torch.ops import upsample_conv as pu

TINY = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
KW = dict(fpn_in=(128, 256, 64), fpn_out=(32, 64, 128), vis_dim=64,
          num_layers=2, num_head=4, dim_ffn=128, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


RNG = np.random.RandomState(0)
X = RNG.randn(2, 8, 12, 5).astype(np.float32)
XS = RNG.randn(2, 8, 12, 20).astype(np.float32)
K3 = RNG.randn(3, 3, 5, 6).astype(np.float32)
K1 = RNG.randn(1, 1, 5, 6).astype(np.float32)
B6 = RNG.randn(6).astype(np.float32)


def test_space_to_depth_round_trip_matches_jax():
    got = ps.space_to_depth(_t(X))
    assert _rel(got, js.space_to_depth(X)) == 0.0
    assert torch.equal(ps.depth_to_space(got), _t(X))
    assert _rel(ps.depth_to_space(_t(XS)), js.depth_to_space(XS)) == 0.0


@pytest.mark.parametrize("name,kernel", [
    ("embed_conv3x3_s2d", K3), ("embed_stem_conv1_s2d", K3),
    ("embed_pool2_conv1x1_s2d", K1), ("embed_conv1x1_s2d", K1),
    ("embed_pool2_conv1x1_s2d_to_s2d", K1)])
def test_s2d_kernel_rearrangements_match_jax(name, kernel):
    assert _rel(getattr(ps, name)(_t(kernel)), getattr(js, name)(kernel)) \
        <= 1e-7


@pytest.mark.parametrize("name,x,kernel", [
    ("stem_conv1_s2d", X, K3), ("conv3x3_s2d", XS, K3),
    ("conv1x1_s2d", XS, K1), ("pool2_conv1x1_s2d_to_s2d", XS, K1)])
def test_s2d_convs_match_jax(name, x, kernel):
    got = getattr(ps, name)(_t(x), _t(kernel), _t(B6), torch.float32)
    ref = getattr(js, name)(x, kernel, B6, jnp.float32)
    assert _rel(got, ref) <= 1e-5


def test_s2d_stem_conv1_is_the_strided_conv_in_s2d_layout():
    ref = torch.nn.functional.conv2d(
        _t(X).permute(0, 3, 1, 2), _t(K3).permute(3, 2, 0, 1), _t(B6), 2, 1)
    got = ps.depth_to_space(ps.stem_conv1_s2d(_t(X), _t(K3), _t(B6),
                                              torch.float32))
    assert _rel(got, ref.permute(0, 2, 3, 1)) <= 1e-5


@pytest.mark.parametrize("name,kernel", [
    ("fold_kernel6", K3), ("fold_kernel4", K1), ("phase_kernels6", K3),
    ("phase_kernels4", K1)])
def test_upsample_fold_kernels_match_jax(name, kernel):
    assert _rel(getattr(pu, name)(_t(kernel)), getattr(ju, name)(kernel)) \
        <= 1e-6


def _interleave(ys):
    """Four (B, H, W, C) phases -> (B, 2H, 2W, C) by the strided writes
    of ``ops.quant.int8_phase_conv_static``."""
    b, h, w, c = ys[0].shape
    out = torch.empty(b, 2 * h, 2 * w, c)
    for (di, dj), y in zip(((0, 0), (0, 1), (1, 0), (1, 1)), ys):
        out[:, di::2, dj::2] = y
    return out


def _phase_core(x, pk, pads):
    """The dilated core as the four f32 phase convs, interleaved."""
    return _interleave([ps.conv_nhwc(x, pk[di, dj], None, 1,
                                     (pads[di], pads[dj]), torch.float32)
                        for di in (0, 1) for dj in (0, 1)])


def test_interleave_and_phase_pads_match_jax():
    ys = [RNG.randn(2, 3, 4, 5).astype(np.float32) for _ in range(4)]
    assert _rel(_interleave(list(map(_t, ys))), ju.interleave2x2(*ys)) == 0.0
    assert pu.PHASE_PADS6 == ju.PHASE_PADS6
    assert pu.PHASE_PADS4 == ju.PHASE_PADS4


@pytest.mark.parametrize("x", [X, X[:, :2, :3]], ids=["8x12", "2x3"])
def test_upsample_convs_match_jax_and_the_chain(x):
    """The transposed-conv up-core with the border corrections against the
    JAX functions and against upsample2x + conv (F.interpolate), at a
    size where the two-wide border strips meet."""
    up = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2),
                                         scale_factor=2, mode="bilinear",
                                         align_corners=False)
    got3 = pu.upsample2x_conv3x3(_t(x), _t(K3), _t(B6))
    assert _rel(got3, ju.upsample2x_conv3x3(x, K3, B6)) <= 1e-5
    chain3 = torch.nn.functional.conv2d(up, _t(K3).permute(3, 2, 0, 1),
                                        _t(B6), padding=1)
    assert _rel(got3, chain3.permute(0, 2, 3, 1)) <= 1e-5
    got1 = pu.upsample2x_conv1x1(_t(x), _t(K1))
    assert _rel(got1, ju.upsample2x_conv1x1(x, K1)) <= 1e-5
    chain1 = torch.nn.functional.conv2d(up, _t(K1).permute(3, 2, 0, 1))
    assert _rel(got1, chain1.permute(0, 2, 3, 1)) <= 1e-5


def test_phase_cores_equal_the_dilated_cores_with_jax_corrections():
    """The phase convs of each kernel (the int8 sites' form) and the
    transposed conv (the bf16 form) equal JAX's lhs-dilated core, and the
    border functions applied to it give the JAX fold."""
    core6 = _phase_core(_t(X), pu.phase_kernels6(_t(K3)), pu.PHASE_PADS6)
    ref6 = jax.lax.conv_general_dilated(
        X, ju.fold_kernel6(K3), (1, 1), [(3, 3), (3, 3)], lhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert _rel(core6, ref6) <= 1e-5
    assert _rel(pu.up_core3x3(_t(X), _t(K3), torch.float32), ref6) <= 1e-5
    got = pu.apply_border_correction3x3(core6.clone(), _t(X), _t(K3))
    ref = ju.apply_border_correction3x3(ref6, X, K3)
    assert _rel(got, ref) <= 1e-5
    core4 = pu.transpose_core(_t(X), pu.fold_kernel4(_t(K1)), torch.float32)
    ref4 = jax.lax.conv_general_dilated(
        X, ju.fold_kernel4(K1), (1, 1), [(2, 2), (2, 2)], lhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert _rel(core4, ref4) <= 1e-5
    assert _rel(_phase_core(_t(X), pu.phase_kernels4(_t(K1)), pu.PHASE_PADS4),
                ref4) <= 1e-5
    got = pu.apply_border_ring1x1(core4.clone(), _t(X), _t(K1))
    assert _rel(got, ju.apply_border_ring1x1(ref4, X, K1)) <= 1e-5


def _jax_apply(module, x, *args):
    variables = module.init(jax.random.PRNGKey(0), x, *args)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return variables, np.asarray(module.apply(variables, x, *args))


def _quant_conv(kernel, bias):
    """A port conv with the JAX kernel (HWIO) and bias."""
    kh, kw, ci, co = kernel.shape
    conv = pl.QuantConv(ci, co, kh, bias=bias is not None, family="backbone")
    with torch.no_grad():
        conv.weight.copy_(_t(kernel).permute(3, 2, 0, 1))
        if bias is not None:
            conv.bias.copy_(_t(bias))
    return conv.eval()


def test_pooled_conv_matches_jax_pooled_conv1x1():
    x = RNG.randn(2, 8, 12, 6).astype(np.float32)
    v, ref = _jax_apply(jl.PooledConv1x1(7, 2, use_bias=True), x)
    conv = _quant_conv(v["params"]["kernel"], v["params"]["bias"])
    got = conv.pooled(_t(x).permute(0, 3, 1, 2), 2)
    assert _rel(got.permute(0, 2, 3, 1), ref) <= 1e-5


def test_s2d_pooled_conv_matches_jax():
    v, ref = _jax_apply(jl.S2dPooledConv1x1(7, use_bias=True), XS)
    conv = _quant_conv(v["params"]["kernel"], v["params"]["bias"])
    got = conv.s2d_pooled(_t(XS).permute(0, 3, 1, 2))
    assert _rel(got.permute(0, 2, 3, 1), ref) <= 1e-5


def test_s2d_conv3x3_matches_jax():
    v, ref = _jax_apply(jl.S2dConv3x3(3, use_bias=True), XS)
    conv = _quant_conv(v["params"]["kernel"], v["params"]["bias"])
    got = conv.s2d3x3(_t(XS).permute(0, 3, 1, 2))
    assert _rel(got.permute(0, 2, 3, 1), ref) <= 1e-5


def _load_cbr(mod, params):
    with torch.no_grad():
        mod[0].weight.copy_(_t(params["conv"]["kernel"]).permute(3, 2, 0, 1))
        mod[0].bias.copy_(_t(params["conv"]["bias"]))
    return mod.eval()


def test_up_conv_bn_relu_matches_jax():
    x = RNG.randn(2, 6, 7, 8).astype(np.float32)
    v, ref = _jax_apply(jl.UpConvBNReLU(5, fold_bn=True), x)
    port = _load_cbr(pl.UpConvBNReLU(8, 5, fold_bn=True, fuse=True),
                     v["params"])
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got, ref) <= 1e-5
    port.fuse = False  # the reference order: the same function
    chain = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(chain, ref) <= 1e-5


def test_cat_up_conv_bn_relu_matches_jax():
    parts = [RNG.randn(2, 8, 10, 3).astype(np.float32),
             RNG.randn(2, 8, 10, 4).astype(np.float32)]
    up = RNG.randn(2, 4, 5, 6).astype(np.float32)
    module = jl.CatUpConvBNReLU(5, fold_bn=True)
    variables = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(1), parts, up))
    ref = np.asarray(module.apply(variables, parts, up))
    port = _load_cbr(pl.CatUpConvBNReLU(13, 5, fold_bn=True, fuse=True),
                     variables["params"])
    args = ([_t(p).permute(0, 3, 1, 2) for p in parts],
            _t(up).permute(0, 3, 1, 2))
    assert _rel(port(*args).permute(0, 2, 3, 1), ref) <= 1e-5
    port.fuse = False
    assert _rel(port(*args).permute(0, 2, 3, 1), ref) <= 1e-5


def _randomize_stats(variables, seed):
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.randn(*a.shape)) * 0.5 + 0.5).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny CRIS with fused pools (its s2d stem and upsample folds
    come on by env in each test), its variables with non-trivial BN
    statistics, and an input."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    word = rng.randint(1, 49000, (2, 17)).astype(np.int32)
    model = dataclasses.replace(tiny_cris(dropout=0.0), fuse_pool=True)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.asarray(img), jnp.asarray(word)))
    return model, _randomize_stats(variables, 5), img, word


def _port(variables, **kw):
    port = CRIS(TINY, **KW, **kw).eval()
    sd = from_jax(variables)
    if kw.get("fold_bn"):
        sd = fold_batchnorm(sd, 64)
    port.load_state_dict({k: torch.as_tensor(np.array(v))
                          for k, v in sd.items()})
    return port


def _run(port, img, word):
    with torch.no_grad():
        return port(_t(img).permute(0, 3, 1, 2),
                    torch.from_numpy(word).long()).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("fold", [False, True])
def test_tiny_model_with_the_rewrites_matches_jax(tiny_pair, monkeypatch,
                                                  fold):
    """All three rewrites on in both packages, f32, at 1e-4; the JAX
    model's rewrites are checked to be on (its reference-order output
    differs from its rewritten one only at rounding)."""
    model, variables, img, word = tiny_pair
    monkeypatch.setenv("CRIS_S2D_STEM", "1")
    monkeypatch.setenv("CRIS_FUSE_UPSAMPLE", "1")
    if fold:
        model = dataclasses.replace(model, fold_bn=True, pos_grid=2)
        jvars = jax_fold(variables, input_resolution=64)
    else:
        jvars = variables
    ref = np.asarray(jax.jit(lambda v, i, w: model.apply(v, i, w,
                                                         train=False))(
        jvars, jnp.asarray(img), jnp.asarray(word)))
    port = _port(variables, rewrites=True, fold_bn=fold,
                 pos_grid=2 if fold else None)
    got = _run(port, img, word)
    print(f"rewrites, fold {fold}: {_rel(got, ref):.3e}")
    assert _rel(got, ref) <= 1e-4
    assert port.backbone.visual.rewrites and port.neck.f2_cat.fuse
    assert port.proj.vis[1].fuse


def test_rewritten_port_equals_its_reference_order(tiny_pair):
    """The port with and without the rewrites on the same weights: eval
    at 1e-5, and a train-mode forward (BN statistics over the s2d phases,
    the fused pools) at 1e-4, with equal running statistics."""
    _, variables, img, word = tiny_pair
    plain, fused = _port(variables), _port(variables, rewrites=True)
    assert _rel(_run(fused, img, word), _run(plain, img, word)) <= 1e-5
    plain.train()
    fused.train()
    with torch.no_grad():
        args = (_t(img).permute(0, 3, 1, 2), torch.from_numpy(word).long())
        ref, got = plain(*args), fused(*args)
    assert _rel(got.numpy(), ref.numpy()) <= 1e-4
    for (name, a), (_, b) in zip(plain.named_buffers(),
                                 fused.named_buffers()):
        if name.endswith("running_var") or name.endswith("running_mean"):
            assert _rel(b.numpy(), a.numpy()) <= 1e-5, name
