"""The route functions that pick a CUDA kernel before each launch, on the
CPU: ``fused_matmul_route`` (K4: the TMA-fed wgmma GEMM or the staged
block_gemm tile), ``attention_route`` (K1 and K3: the tensor-core body
or the scalar one) and ``attention_dropout_route`` (K2: the tensor-core
kernels or the scalar ones). All read only dtypes, shapes, strides and
data pointers, so CPU tensors stand in for the card's; the kernels
themselves run on the card in chip_smoke.py phases 2, 6, 8 and 11, which
assert the same routes there."""

import numpy as np
import pytest
import torch

from cris_tpu_torch.models import CLIPConfig, CRIS, init_weights
from cris_tpu_torch.ops import attention as port_ops
from cris_tpu_torch.ops.kernels import (attention_dropout_backward,
                                        attention_dropout_route,
                                        fused_attention_bse,
                                        fused_attention_bse_dropout,
                                        fused_matmul)
from cris_tpu_torch.ops.kernels.attention import attention_route, split_heads
from cris_tpu_torch.ops.kernels.fused_matmul import fused_matmul_route

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

    def spy(q, k, v, num_heads, kv_valid, rate, seed):
        calls.append((q, k, v, num_heads))
        return kernel(q, k, v, num_heads, kv_valid, rate, seed)

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
