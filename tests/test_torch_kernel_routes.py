"""The route functions that pick a CUDA kernel before each launch, on the
CPU: ``fused_matmul_route`` (K4: the TMA-fed wgmma GEMM or the staged
block_gemm tile), ``attention_route`` (K1 and K3: the tensor-core body
or the scalar one), ``attention_dropout_route`` (K2: the tensor-core
kernels or the scalar ones), ``bottleneck_route`` (K5: the
tensor-core body or the staged one) and ``stem_route`` (K7: the
tensor-core body or the staged one). All read only dtypes, shapes,
strides and data pointers, so CPU tensors stand in for the card's; the
kernels themselves run on the card in chip_smoke.py phases 2, 6, 8, 9,
10 and 11, which assert the same routes there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cris_tpu_torch.models import CLIPConfig, CRIS, init_weights
from cris_tpu_torch.ops import attention as port_ops
from cris_tpu_torch.ops.kernels import (attention_dropout_backward,
                                        attention_dropout_route,
                                        fused_attention_bse,
                                        fused_attention_bse_dropout,
                                        fused_bottleneck, fused_matmul,
                                        fused_stem_pool, stem_route)
from cris_tpu_torch.ops.kernels.attention import attention_route, split_heads
from cris_tpu_torch.ops.kernels.bottleneck import (K5_TAILS, TAIL_RULES,
                                                   _tc_rows, _tc_smem_bytes,
                                                   bottleneck_route,
                                                   bottleneck_takes)
from cris_tpu_torch.ops.kernels.fused_matmul import fused_matmul_route
from cris_tpu_torch.ops.kernels.stem import TC_TILES
from cris_tpu_torch.ops.kernels.stem import _tc_smem_bytes as _stem_smem_bytes

BF16 = torch.bfloat16

# ---------------------------------------------------------------- K4

# (site, M, K, N) at B 1: the decoder FFN and the R50 1x1 convs of
# chip_smoke.py phase 11 (M does not enter the route)
K4_SITES = [
    ("decoder FFN fc1", 676, 512, 2048),
    ("decoder FFN fc2", 676, 2048, 512),
    ("layer1 conv1 256->64", 104 * 104, 256, 64),
    ("layer1 conv3 64->256", 104 * 104, 64, 256),
    ("layer3 conv3 256->1024", 26 * 26, 256, 1024),
    ("layer4 conv1 2048->512", 13 * 13, 2048, 512),
]


def _mat(*shape, dtype=BF16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("site,m,k,n", K4_SITES, ids=[s[0] for s in K4_SITES])
def test_bf16_contiguous_sites_take_wgmma(site, m, k, n):
    """x (M, K) and a contiguous (K, N) w."""
    assert fused_matmul_route(_mat(m, k), _mat(k, n)) == "wgmma"


@pytest.mark.parametrize("site,m,k,n", K4_SITES[:2] + K4_SITES[5:],
                         ids=[s[0] for s in K4_SITES[:2] + K4_SITES[5:]])
def test_k_major_weight_takes_wgmma(site, m, k, n):
    """An nn.Linear weight is (N, K): a model caller passes weight.t(), a
    (K, N) view with unit stride along K."""
    w = _mat(n, k).t()
    assert w.stride() == (1, k)
    assert fused_matmul_route(_mat(m, k), w) == "wgmma"


def test_conv1x1_input_rows_take_wgmma():
    """conv1x1_fused's NHWC map viewed as (pixels, Cin) rows."""
    x = _mat(2, 13, 13, 2048).reshape(-1, 2048)
    assert fused_matmul_route(x, _mat(1, 1, 2048, 512)[0, 0]) == "wgmma"


@pytest.mark.parametrize("case", ["float32", "ragged K 70", "column slice",
                                  "weight row stride"])
def test_staged_route(case):
    """f32 products stay f32 FMAs; 140-byte rows, a base 6 bytes off a
    16-byte boundary and weight rows 8 bytes off a 16-byte multiple are
    layouts the TMA route does not take."""
    if case == "float32":
        x, w = _mat(676, 512, dtype=torch.float32), \
            _mat(512, 2048, dtype=torch.float32)
    elif case == "ragged K 70":  # the JAX test's (300, 70) -> 130
        x, w = _mat(300, 70), _mat(70, 130)
    elif case == "column slice":
        x, w = _mat(676, 600)[:, 3:515], _mat(512, 2048)
        assert x.data_ptr() % 16 == 6
    else:
        x, w = _mat(676, 512), _mat(512, 2052)[:, :2048]
        assert w.stride(0) * 2 % 16 == 8
    assert fused_matmul_route(x, w) == "staged"


def test_route_reads_no_values():
    """Two tensors of one layout and different values take one route; a
    CPU call launches nothing on either route."""
    x, w = torch.randn(64, 512).to(BF16), torch.randn(512, 256).to(BF16)
    assert fused_matmul_route(x, w) == fused_matmul_route(x * 0, w * 0)
    before = dict(fused_matmul.launches_by_route)
    fused_matmul(x, w, torch.zeros(256))
    assert fused_matmul.launches_by_route == before


# ---------------------------------------------------------- K1 and K3


@pytest.mark.parametrize("d", [16, 48, 64, 128])
@pytest.mark.parametrize("layout", ["K1 (B, S, E)", "K3 head views",
                                    "K3 contiguous"])
def test_bf16_heads_take_tensor_cores(d, layout):
    """Head dims that are multiples of 8, at K1's rows and at K3's head
    tensors, views or contiguous."""
    h = 4
    q, kv = _mat(2, 30, h * d), _mat(2, 21, h * d)
    if layout != "K1 (B, S, E)":
        q, kv = split_heads(q, h), split_heads(kv, h)
        if layout == "K3 contiguous":
            q, kv = q.contiguous(), kv.contiguous()
    assert attention_route(q, kv, kv, d) == "tensor_cores"


@pytest.mark.parametrize("case", ["head dim 12", "misaligned view",
                                  "float32", "odd row stride"])
def test_scalar_route(case):
    """A 12-wide head, a view 8 bytes off a 16-byte boundary, float32, and
    rows 8 bytes apart from a multiple of 16 take the scalar body."""
    d, h = 64, 4
    q = _mat(2, 30, h * d)
    if case == "head dim 12":
        d, q = 12, _mat(2, 30, 48)
    elif case == "misaligned view":
        q = _mat(2, 30, h * d + 4)[..., 4:]
        assert q.data_ptr() % 16 == 8
    elif case == "float32":
        q = q.float()
    else:
        q = _mat(2, 30, h * d + 4)[..., :h * d]
        assert q.stride(1) % 8 == 4
    assert attention_route(q, q, q, d) == "scalar"


def test_tiny_cris_attention_sites_take_tensor_cores(monkeypatch):
    """Every K1 call of a tiny CRIS forward (decoder self- and
    cross-attention, attnpool) is admitted by the tensor-core body once
    its inputs are cast to bf16 as autocast casts the projections: the
    model's real sites take the new body."""
    calls = []
    kernel = port_ops.fused_attention_bse

    def spy(q, k, v, num_heads, kv_valid=None):
        calls.append((q, k, v, num_heads))
        return kernel(q, k, v, num_heads, kv_valid)

    monkeypatch.setattr(port_ops, "fused_attention_bse", spy)
    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    model = init_weights(CRIS(ccfg, fpn_in=(128, 256, 64),
                              fpn_out=(32, 64, 128), vis_dim=64, num_layers=2,
                              num_head=4, dim_ffn=128, dropout=0.0), 0).eval()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    word = torch.from_numpy(rng.randint(1, 49407, (2, 17)))
    word[1, 9:] = 0  # padded words: the cross-attention's key mask
    with torch.no_grad():
        model(img, word)
    # attnpool + 2 decoder layers x (self, cross)
    assert len(calls) == 5
    for q, k, v, heads in calls:
        cast = [x.to(BF16) for x in (q, k, v)]
        assert attention_route(*cast, q.shape[-1] // heads) == "tensor_cores"
    assert fused_attention_bse.launches_by_route == dict.fromkeys(
        fused_attention_bse.launches_by_route, 0)


# ------------------------------------------------------------------ K2

# (site, B, S, T, E, heads): the decoder's self- and cross-attention at
# the train path's B 32 (R50: 8 heads x 64), and cris_tiny's decoder (64
# wide, 4 heads: head dim 16)
K2_SITES = [
    ("decoder self-attn", 32, 676, 676, 512, 8),
    ("decoder cross-attn", 32, 676, 17, 512, 8),
    ("cris_tiny decoder", 2, 16, 17, 64, 4),
]


@pytest.mark.parametrize("site,b,s,t,e,h", K2_SITES,
                         ids=[x[0] for x in K2_SITES])
def test_k2_bf16_sites_take_tensor_cores(site, b, s, t, e, h):
    """(B, L, E) projections in bf16, as autocast hands them to K2."""
    q, kv = _mat(b, s, e), _mat(b, t, e)
    assert attention_dropout_route(q, kv, kv, h) == "tensor_cores"


@pytest.mark.parametrize("case", ["float32", "unaligned row stride",
                                  "head dim 12"])
def test_k2_scalar_route(case):
    """f32, rows 8 bytes off a multiple of 16 (a slice of wider rows) and
    a 12-wide head keep the scalar kernels."""
    h, e = 8, 512
    q = _mat(2, 30, e)
    if case == "float32":
        q = q.float()
    elif case == "unaligned row stride":
        q = _mat(2, 30, e + 4)[..., :e]
        assert q.stride(1) * 2 % 16 == 8
    else:
        h, q = 4, _mat(2, 30, 48)
    assert attention_dropout_route(q, q, q, h) == "scalar"


def test_k2_route_reads_no_values():
    """Two tensors of one layout and different values take one route; a
    CPU call takes the plain version and launches nothing on either
    route, forward or backward."""
    q = torch.randn(2, 30, 64).to(BF16)
    assert attention_dropout_route(q, q, q, 4) == attention_dropout_route(
        q * 0, q * 0, q * 0, 4)
    before = (dict(fused_attention_bse_dropout.launches_by_route),
              dict(attention_dropout_backward.launches_by_route))
    qg = q.float().requires_grad_()
    fused_attention_bse_dropout(qg, qg, qg, 4, None, 0.1, 3).sum().backward()
    assert (fused_attention_bse_dropout.launches_by_route,
            attention_dropout_backward.launches_by_route) == before


def test_tiny_cris_train_sites_take_tensor_cores(monkeypatch):
    """Every K2 call of a tiny CRIS train forward (the decoder's self- and
    cross-attention of each layer) is admitted by the tensor-core kernels
    once its inputs are cast to bf16 as autocast casts the projections."""
    calls = []
    kernel = port_ops.fused_attention_bse_dropout

    def spy(q, k, v, num_heads, kv_valid, rate, seed, batch_offset=0,
            head_offset=0):
        calls.append((q, k, v, num_heads))
        return kernel(q, k, v, num_heads, kv_valid, rate, seed, batch_offset,
                      head_offset)

    monkeypatch.setattr(port_ops, "fused_attention_bse_dropout", spy)
    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    model = init_weights(CRIS(ccfg, fpn_in=(128, 256, 64),
                              fpn_out=(32, 64, 128), vis_dim=64, num_layers=2,
                              num_head=4, dim_ffn=128, dropout=0.1), 0).train()
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    word = torch.from_numpy(rng.randint(1, 49407, (2, 17)))
    word[1, 9:] = 0
    with torch.no_grad():
        model(img, word, dropout_seed=3)
    assert len(calls) == 4  # 2 decoder layers x (self, cross)
    for q, k, v, heads in calls:
        cast = [x.to(BF16) for x in (q, k, v)]
        assert attention_dropout_route(*cast, heads) == "tensor_cores"


# ---------------------------------------------------------------- K5

# the R50 tails at 416 px: (site, H = W, C, mid)
K5_SITES = [
    ("layer1 tail", 104, 256, 64),
    ("layer2 tail", 52, 512, 128),
    ("layer3 tail", 26, 1024, 256),
    ("layer4 tail", 13, 2048, 512),
]


def _k5_operands(h, c, mid, dtype=BF16, nchw=True):
    """x as the model hands it (an NHWC view of NCHW memory) or contiguous
    NHWC, and contiguous weights, as the wrapper passes them."""
    x = _mat(2, c, h, h, dtype=dtype).permute(0, 2, 3, 1) if nchw else \
        _mat(2, h, h, c, dtype=dtype)
    return x, _mat(c, mid, dtype=dtype), _mat(9, mid, mid, dtype=dtype), \
        _mat(mid, c, dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nchw", [True, False], ids=["NCHW view", "NHWC"])
@pytest.mark.parametrize("site,h,c,mid", K5_SITES,
                         ids=[s[0] for s in K5_SITES])
def test_k5_r50_tails_route(site, h, c, mid, nchw, dtype):
    """Every R50 tail takes the tensor cores in bf16, layer1's mid 64
    included, whatever x's layout; f32 takes the staged body."""
    operands = _k5_operands(h, c, mid, getattr(torch, dtype), nchw)
    want = "tensor_cores" if dtype == "bfloat16" else "staged"
    assert bottleneck_route(*operands) == want


@pytest.mark.parametrize("case", ["odd channels", "mid 48", "mid 2048",
                                  "width 400", "weight offset",
                                  "mixed dtypes"])
def test_k5_staged_route(case):
    """Shapes the tensor-core body refuses: channels or mid that are not
    multiples of 64, a mid or a width whose one-row band does not fit
    shared memory, a weight 8 bytes off a 16-byte boundary, and weights in
    another dtype than x."""
    h, c, mid = 13, 256, 64
    if case == "odd channels":
        c = 250
    elif case == "mid 48":
        mid = 48
    elif case == "mid 2048":
        mid = 2048
    elif case == "width 400":
        h, c, mid = 400, 64, 256
    x, w1, w2, w3 = _k5_operands(h, c, mid)
    if case == "weight offset":
        w1 = _mat(c * mid + 4)[4:].view(c, mid)
        assert w1.data_ptr() % 16 == 8
    elif case == "mixed dtypes":
        w3 = w3.float()
    assert bottleneck_route(x, w1, w2, w3) == "staged"


def test_k5_tc_shared_memory_of_the_r50_tails():
    """The route's fit test is the C side's formula: the smallest band
    (one row, M tiles of 32) fits every R50 tail, and layer4's rows are
    what the body's flat padded grid needs."""
    for _, h, _, mid in K5_SITES:
        assert _tc_smem_bytes(1, h, mid, 32, 32, 1) <= 232448
    for shift, want in ((0, (64, 32)), (1, (80, 32))):
        m1, m2 = _tc_rows(2, 13, 32, shift)
        assert (m1, m2) == want
        assert m2 >= 2 * 15 and m1 >= m2 + 2 * 15 + 2 + shift
        assert m1 >= 4 * 15 + shift


def test_k5_route_reads_no_values():
    """Two operand sets of one layout and different values take one route;
    a CPU call launches nothing on either route."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 6, 6, generator=gen).to(BF16).permute(0, 2, 3, 1)
    ws = [torch.randn(*s, generator=gen).to(BF16)
          for s in ((64, 64), (9, 64, 64), (64, 64))]
    assert bottleneck_route(x, *ws) == bottleneck_route(
        x * 0, *(w * 0 for w in ws)) == "tensor_cores"
    before = dict(fused_bottleneck.launches_by_route)
    bias = torch.zeros(64)
    fused_bottleneck(x, ws[0], bias, ws[1], bias, ws[2], bias)
    assert fused_bottleneck.launches_by_route == before


@pytest.mark.parametrize("rule", TAIL_RULES)
@pytest.mark.parametrize("site,h,c,mid", K5_SITES,
                         ids=[s[0] for s in K5_SITES])
def test_k5_tail_gate_at_the_r50_tails(site, h, c, mid, rule):
    """"every" takes all four R50 tails; "narrow" takes in bf16 the 104^2
    and 52^2 tails (mid 64 and 128), where K5 beat the cuDNN chain, and
    in f32 every tail. The gate reads integers and a dtype, so no tensor
    is made."""
    assert bottleneck_takes(h, h, c, mid, BF16, rule) is (
        rule == "every" or mid <= 128)
    assert bottleneck_takes(h, h, c, mid, torch.float32, rule) is True


@pytest.mark.parametrize("shape", [(26, 26, 1024, 256), (13, 13, 2048, 512),
                                   (40, 40, 768, 192), (7, 7, 2048, 512)],
                         ids=["R50 layer3", "R50 layer4", "mid 192",
                              "224 px layer4"])
def test_k5_tail_gate_refuses(shape):
    """The "narrow" rule refuses bf16 tails wider than mid 128, whatever
    their spatial size; "every" takes them; an unknown rule raises."""
    assert not bottleneck_takes(*shape, BF16, "narrow")
    assert bottleneck_takes(*shape, BF16, "every")
    with pytest.raises(ValueError, match="tail rule"):
        bottleneck_takes(*shape, BF16, "wide")


@pytest.mark.parametrize("rule", [True, *TAIL_RULES])
def test_folded_tails_consult_the_gate(rule, monkeypatch):
    """A folded tiny CRIS with tails (1, 2, 2, 1) asks the gate about each
    tail with the rule it was built with (True: K5_TAILS) at its input's
    shape and compute dtype, and runs K5 only where the gate takes it."""
    from cris_tpu_torch.models import clip_resnet

    asked, ran = [], []

    def gate(h, w, c, mid, dtype, tails):
        asked.append((h, w, c, mid, dtype, tails))
        return h == 8  # layer2's tail only

    def k5(*args):
        ran.append(args[0].shape)
        return args[0]

    monkeypatch.setattr(clip_resnet, "bottleneck_takes", gate)
    monkeypatch.setattr(clip_resnet, "fused_bottleneck", k5)
    ccfg = CLIPConfig(64, 64, (1, 2, 2, 1), 16, None, 77, 49408, 64, 4, 2)
    model = init_weights(CRIS(ccfg, fpn_in=(128, 256, 64),
                              fpn_out=(32, 64, 128), vis_dim=64, num_layers=1,
                              num_head=4, dim_ffn=128, dropout=0.0,
                              fold_bn=True, fused_bottleneck=rule), 0).eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64), torch.ones(1, 17, dtype=torch.long))
    want = K5_TAILS if rule is True else rule
    assert asked == [(8, 8, 128, 32, torch.float32, want),
                     (4, 4, 256, 64, torch.float32, want)]
    assert ran == [(1, 8, 8, 128)]


# ---------------------------------------------------------------- K7

# the R50 stem at 416 px: (H = W, C1, C2, C3)
K7_R50 = (416, 32, 32, 64)


def _k7_operands(h, c1, c2, c3, dtype=BF16, nchw=True):
    """The image as the model hands it (an NHWC view of f32 NCHW memory)
    or contiguous NHWC, and contiguous HWIO kernels."""
    img = _mat(2, 3, h, h, dtype=torch.float32).permute(0, 2, 3, 1) if nchw \
        else _mat(2, h, h, 3, dtype=torch.float32)
    return img, _mat(3, 3, 3, c1, dtype=dtype), \
        _mat(3, 3, c1, c2, dtype=dtype), _mat(3, 3, c2, c3, dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nchw", [True, False], ids=["NCHW view", "NHWC"])
def test_k7_r50_stem_route(nchw, dtype):
    """The R50 stem takes the tensor cores in bf16 whatever the image's
    layout; f32 takes the staged body."""
    operands = _k7_operands(*K7_R50, getattr(torch, dtype), nchw)
    want = "tensor_cores" if dtype == "bfloat16" else "staged"
    assert stem_route(*operands) == want


@pytest.mark.parametrize("case", ["C1 24", "C3 40", "weight offset",
                                  "mixed dtypes", "RN50x64 64/64/128"])
def test_k7_staged_route(case):
    """Shapes the tensor-core body refuses: widths that are not multiples
    of 16, a weight 8 bytes off a 16-byte boundary, kernels in two dtypes,
    and widths whose weights leave no room for the smallest tile."""
    widths = {"C1 24": (24, 32, 64), "C3 40": (32, 32, 40),
              "RN50x64 64/64/128": (64, 64, 128)}.get(case, (32, 32, 64))
    img, k1, k2, k3 = _k7_operands(64, *widths)
    if case == "weight offset":
        k2 = _mat(9 * 32 * 32 + 4)[4:].view(3, 3, 32, 32)
        assert k2.data_ptr() % 16 == 8
    elif case == "mixed dtypes":
        k3 = k3.float()
    assert stem_route(img, k1, k2, k3) == "staged"


def _c_stem_smem_bytes():
    """stem.cu's ``stem_tc_smem_bytes``, its body evaluated as Python: the
    C side's own formula, read from the source."""
    src = (Path(__file__).resolve().parents[1] / "cris_tpu_torch" / "csrc"
           / "stem.cu").read_text()
    k_k1 = int(re.search(r"constexpr int kK1 = (\d+);", src).group(1))
    body = re.search(r"inline size_t stem_tc_smem_bytes\(int th, int tw, "
                     r"int c1, int c2, int c3\) \{(.*?)\n\}", src, re.S)
    code = body.group(1).replace("(size_t)", "").replace("const size_t ", "")
    code = code.replace("std::max", "max")
    code = code.replace("return", "result =").replace(";", "\n")
    code = "\n".join(line.strip() for line in code.splitlines())

    def smem(th, tw, c1, c2, c3):
        scope = dict(th=th, tw=tw, c1=c1, c2=c2, c3=c3, kK1=k_k1)
        exec(code, {}, scope)
        return scope["result"]
    return smem


def test_k7_tc_shared_memory_is_the_c_sides():
    """The route's fit test is the C side's formula on every candidate
    tile at the R50 and the refused widths; the C side's candidates are
    TC_TILES; the R50 stem's tiles fit (the two reference tiles at about
    224 and 198 KB), RN50x64's smallest does not."""
    c_smem = _c_stem_smem_bytes()
    for widths in ((32, 32, 64), (16, 16, 16), (48, 48, 96), (64, 64, 128)):
        for th, tw in TC_TILES:
            assert _stem_smem_bytes(th, tw, *widths) == c_smem(th, tw,
                                                               *widths)
    src = (Path(__file__).resolve().parents[1] / "cris_tpu_torch" / "csrc"
           / "stem.cu").read_text()
    th_max = int(re.search(r"constexpr int kThMax = (\d+);", src).group(1))
    tws = re.search(r"constexpr int kTws\[\d\] = \{([^}]*)\};", src).group(1)
    assert TC_TILES == tuple((th, int(tw)) for tw in tws.split(",")
                             for th in range(2, th_max + 1, 2))
    assert _stem_smem_bytes(16, 32, 32, 32, 64) == 228944
    assert _stem_smem_bytes(8, 48, 32, 32, 64) == 203216
    fits = [t for t in TC_TILES if _stem_smem_bytes(*t, 32, 32, 64) <= 232448]
    assert (16, 32) in fits and (10, 48) in fits and len(fits) == 32
    assert _stem_smem_bytes(2, 16, 64, 64, 128) > 232448


def test_k7_route_reads_no_values():
    """Two operand sets of one layout and different values take one route;
    a CPU call launches nothing on either route."""
    gen = torch.Generator().manual_seed(0)
    img = torch.randn(1, 3, 16, 16, generator=gen).permute(0, 2, 3, 1)
    ks = [(torch.randn(*s, generator=gen) * 0.2).to(BF16)
          for s in ((3, 3, 3, 16), (3, 3, 16, 16), (3, 3, 16, 32))]
    assert stem_route(img, *ks) == stem_route(
        img * 0, *(k * 0 for k in ks)) == "tensor_cores"
    before = dict(fused_stem_pool.launches_by_route)
    bias = torch.zeros(32)
    out = fused_stem_pool(img, ks[0], bias[:16], ks[1], bias[:16], ks[2],
                          bias)
    assert out.shape == (1, 4, 4, 32)
    assert fused_stem_pool.launches_by_route == before
