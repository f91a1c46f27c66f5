"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
1. card, versions, and the build of the CUDA kernels from cris_tpu_torch/csrc;
2. K1 against its plain PyTorch version at B = 16 on the main path's
   shapes and at head dims 16, 48 and 128, f32 (rtol = atol = 1e-4) and
   bf16 (rtol = atol = 2e-2, mean |err| < 2e-3), with CUDA-event times of
   both;
3. CRIS-R50 at 416 px (word_len 17, 3 decoder layers, seeded random
   weights): one f32 batch of 2 on the card against the same model on the
   CPU (relative L2 of the logits <= 1e-4, mask agreement at 0.35 >= 0.999);
4. three requests through PredictService.predict in bf16 autocast (1, 5
   and 16 sentences: buckets 1, 8 and 16); each mask has its image's
   shape, the probabilities are finite, and K1 launched exactly 7 times
   per device batch (3 decoder layers x 2 sites + attnpool).
5. K1's gradient (kernel forward, plain recompute backward) against
   autograd through its plain version at the R50 sites, B 16, at the
   phase-2 tolerances (in units of a tensor's RMS where that exceeds 1;
   for bf16 inputs the reference runs in f32 on them), with forward +
   backward times;
6. K2 (attention dropout, forward and backward kernels) against its plain
   version with the same seed, at the decoder's self- and
   cross-attention, rate 0.1, at B 16 and at the train path's B 32 (its
   cross-attention with each row's words drawn as the train batches draw
   them, 3 to 17 valid): output and dq/dk/dv as in phase 5; rate 0
   equals K1; one seed gives the same bits, another seed other bits; the
   backward kernels alone give the autograd path's bits; the keep
   fraction within 6 sigma of 0.9; the forward's row counts and the
   backward's column counts of the mask equal the plain mask's (uniform
   attention, V = 1, dO = 1); times of forward, backward alone and both;
7. the R50 f32 train step at dropout 0, batch 8: card against CPU (loss
   relative error <= 1e-4; the gradients' global relative L2, over all
   tensors and over the head, within 1e-3 plus 1.6 times the CPU's own
   spread with oneDNN off, which these random weights make about 3.5%,
   and each tensor within 1e-3 of its norm plus twice that spread on it,
   factors set from cris_tpu_torch/grad_spread.py's readings); three
   planted faults must fail those bars;
8. R50 training in bf16 autocast at dropout 0.1, batch 32, 8 steps on
   seeded batches: finite losses and gradients, BN running statistics
   move, group learning rates 1e-5 / 1e-4, and per step K2 forward and
   backward 6 launches each (3 layers x 2 sites) and K1 one (attnpool);
   the median step time of steps 3-8 and the peak memory.
The last lines are a JSON summary of the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NVSMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
B = 16
# (site, S, T, H, D, masked keys at the end of each row)
SHAPES = [
    ("decoder self-attn", 676, 676, 8, 64, 0),
    ("decoder cross-attn, 17 words", 676, 17, 8, 64, 5),
    ("decoder cross-attn, 22 words", 676, 22, 8, 64, 0),
    ("attnpool", 169, 169, 32, 64, 0),
    ("odd", 100, 37, 4, 32, 6),
    # head dims off the R50 path: cris_tiny's decoder (64 / 4 heads), one
    # padded to the next tile width, and the widest the gate admits
    ("head dim 16 (cris_tiny decoder)", 16, 17, 4, 16, 5),
    ("head dim 48", 100, 37, 4, 48, 6),
    ("head dim 128", 676, 676, 4, 128, 0),
]
# K2's sites, (site, B, S, T, H, D, masked keys): the decoder's at B 16
# with the same mask in every row, and at the train path's B 32, where
# "rows" draws each row's valid words as the train batches do (3 to 17)
K2_SITES = [(site, B, s, t, h, d, m) for site, s, t, h, d, m in SHAPES[:3]] + [
    ("decoder self-attn, train batch", 32, 676, 676, 8, 64, 0),
    ("decoder cross-attn, train batch", 32, 676, 17, 8, 64, "rows"),
]


def card_line() -> str:
    out = subprocess.run(NVSMI, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(fused, plain):
    """K1 vs its plain version; returns (rows, max_abs_err, ms, plain_ms)."""
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, s, t, h, d, masked in SHAPES:
        e = h * d
        q = torch.randn(B, s, e, device="cuda", generator=gen)
        k = torch.randn(B, t, e, device="cuda", generator=gen)
        v = torch.randn(B, t, e, device="cuda", generator=gen)
        valid = None
        if masked:
            valid = torch.ones(B, t, dtype=torch.bool, device="cuda")
            valid[:, t - masked:] = False
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            got = fused(qd, kd, vd, h, valid)
            ref = plain(qd, kd, vd, h, valid)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            else:
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=2e-2, atol=2e-2)
                assert err.mean().item() < 2e-3, (site, err.mean().item())
            # plain, kernel, kernel, plain: both see the same conditions
            p1 = cuda_ms(lambda: plain(qd, kd, vd, h, valid))
            k1 = cuda_ms(lambda: fused(qd, kd, vd, h, valid))
            k2 = cuda_ms(lambda: fused(qd, kd, vd, h, valid))
            p2 = cuda_ms(lambda: plain(qd, kd, vd, h, valid))
            row = dict(site=site, B=B, S=s, T=t, H=h, D=d, masked=masked,
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item(),
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
            worst = max(worst, row["max_abs_err"])
            rows.append(row)
            print(f"K1 {site:30s} {row['dtype']:8s} S={s} T={t} H={h} D={d} "
                  f"max|err|={row['max_abs_err']:.3e} "
                  f"mean|err|={row['mean_abs_err']:.3e} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms",
                  flush=True)
    main = next(r for r in rows if r["site"] == "decoder self-attn"
                and r["dtype"] == "bfloat16")
    return rows, worst, main["ms"], main["plain_ms"]


def phase_model(cfg, build_segmenter, tokenize):
    """f32 R50 on the card against the same weights on the CPU."""
    model = build_segmenter(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, cfg.input_size, cfg.input_size, generator=gen)
    word = torch.from_numpy(tokenize(
        ["the man in the red shirt on the left", "a dog"], cfg.word_len,
        True)).long()
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = model(img, word)
        cpu_s = time.perf_counter() - t0
        model.cuda()
        got = model(img.cuda(), word.cuda())
        torch.cuda.synchronize()
    got = got.cpu()
    assert got.shape == (2, 1, cfg.input_size // 4, cfg.input_size // 4), got.shape
    assert torch.isfinite(got).all()
    rel = ((got - ref).norm() / ref.norm()).item()
    agree = ((torch.sigmoid(got) > 0.35) == (torch.sigmoid(ref) > 0.35)
             ).float().mean().item()
    print(f"R50 f32 card vs CPU: logits {tuple(got.shape)} rel L2 {rel:.3e} "
          f"mask agreement {agree:.6f} (CPU forward {cpu_s:.1f} s)", flush=True)
    assert rel <= 1e-4, rel
    assert agree >= 0.999, agree
    del model


def phase_serving(cfg, PredictService, fused):
    service = PredictService(cfg, device="cuda", max_batch=16)
    batches = []
    inner = service.evaluator.predict_probs

    def checked(image, word):
        probs = inner(image, word)
        batches.append(image.shape[0])
        assert np.isfinite(probs).all(), "non-finite probabilities"
        return probs

    service.evaluator.predict_probs = checked
    rng = np.random.RandomState(0)
    requests = [((480, 640), 1), ((427, 640), 5), ((640, 480), 16)]
    words = ["the", "man", "left", "red", "shirt", "dog", "on", "a", "chair"]
    latencies = []
    fused.launches = 0
    for (h, w), n in requests:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        sents = [" ".join(rng.choice(words, 1 + i % 6)) for i in range(n)]
        t0 = time.perf_counter()
        results = service.predict(image, sents)
        latencies.append((time.perf_counter() - t0) * 1e3)
        assert len(results) == n
        for r in results:
            assert r["mask"].shape == (h, w) and r["mask"].dtype == bool
    launches = fused.launches
    for ((h, w), n), b, ms in zip(requests, batches, latencies):
        print(f"request {h}x{w} with {n} sentences: bucket {b}, "
              f"latency {ms:.2f} ms", flush=True)
    assert batches == [1, 8, 16], batches
    assert launches == 7 * len(batches), (launches, batches)
    print(f"K1 launches on the serving path: {launches} "
          f"({len(batches)} device batches x 7)", flush=True)
    return launches, latencies


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _check(got, ref, dtype, what):
    """Phase-2 tolerances, in units of the reference's RMS where that
    exceeds 1 (a key's gradient sums over 676 queries and is several units
    large; bf16 rounds it in proportion). Returns the max abs error."""
    scale = max(1.0, ref.float().square().mean().sqrt().item())
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   msg=what)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2 * scale, msg=what)
        assert err.mean().item() < 2e-3 * scale, (what, err.mean().item(), scale)
    return err.max().item()


def _reference(fn, q, k, v, g):
    """Output and gradients of the plain version, in f32 on the same
    inputs. In bf16 the plain version's autograd rounds dW to bf16 through
    the weights' cast; neither kernel path nor the JAX backward does, so
    the bf16 reference is the f32 computation on the bf16 inputs."""
    return _fwd_bwd(fn, *(x.float() for x in (q, k, v, g)))


def _fwd_bwd(fn, q, k, v, g):
    """Output and (dq, dk, dv) of fn(q, k, v) for the output gradient g."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad


def _word_valid(b, t):
    """(b, t) key mask with each row's valid words drawn as the train
    path's batches draw them (make_batches: 3 to t valid, the rest
    padding)."""
    from cris_tpu_torch.profile_train import make_batches

    return make_batches(1, b, 8, t, "cuda", seed=9)[0]["word"] != 0


def _site_inputs(gen, b, s, t, h, d, masked, dtype, device="cuda"):
    e = h * d
    q, k, v = (torch.randn(b, n, e, device=device, generator=gen).to(dtype)
               for n in (s, t, t))
    g = torch.randn(b, s, e, device=device, generator=gen).to(dtype)
    valid = None
    if masked == "rows":
        valid = _word_valid(b, t)
    elif masked:
        valid = torch.ones(b, t, dtype=torch.bool, device=device)
        valid[:, t - masked:] = False
    return q, k, v, g, valid


def phase_k1_backward(fused, plain):
    """K1's autograd.Function against autograd through attention_plain."""
    rows, worst = [], 0.0
    gen = torch.Generator(device="cuda").manual_seed(5)
    for site, s, t, h, d, masked in SHAPES[:4]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, valid = _site_inputs(gen, B, s, t, h, d, masked, dtype)
            kern = lambda q, k, v: fused(q, k, v, h, valid)  # noqa: E731
            ref_fn = lambda q, k, v: plain(q, k, v, h, valid)  # noqa: E731
            got = _fwd_bwd(kern, q, k, v, g)
            ref = _reference(ref_fn, q, k, v, g)
            torch.cuda.synchronize()
            errs = [_check(a, b, dtype, f"K1 grad {site} {dtype} {n}")
                    for n, a, b in zip(("out", "dq", "dk", "dv"), got, ref)]
            p1 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            k1 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            k2 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            p2 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            row = dict(site=site, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=max(errs), fwd_bwd_ms=(k1 + k2) / 2,
                       plain_fwd_bwd_ms=(p1 + p2) / 2)
            worst = max(worst, row["max_abs_err"])
            rows.append(row)
            print(f"K1 fwd+bwd {site:30s} {row['dtype']:8s} max|err| "
                  f"{row['max_abs_err']:.3e} (out, dq, dk, dv) kernel "
                  f"{row['fwd_bwd_ms']:.4f} ms  plain "
                  f"{row['plain_fwd_bwd_ms']:.4f} ms", flush=True)
    return rows, worst


def phase_k2(k2, k2_fwd, k2_bwd, plain_k2, k1, keep_mask, rate=0.1):
    """K2 against its plain version with the same seed. The backward
    kernels are also timed alone, on the output and log-sum-exp of one
    forward, against torch.autograd.grad through the plain graph built by
    one forward."""
    rows, worst_fwd, worst_bwd = [], 0.0, 0.0
    gen = torch.Generator(device="cuda").manual_seed(6)
    for site, b, s, t, h, d, masked in K2_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, valid = _site_inputs(gen, b, s, t, h, d, masked, dtype)
            seed = 1234567 + b + s + t
            kern = lambda q, k, v: k2(q, k, v, h, valid, rate, seed)  # noqa: E731
            ref_fn = lambda q, k, v: plain_k2(q, k, v, h, valid, rate, seed)  # noqa: E731
            before = (k2.launches, k2_bwd.launches)
            got = _fwd_bwd(kern, q, k, v, g)
            assert (k2.launches, k2_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
            ref = _reference(ref_fn, q, k, v, g)
            torch.cuda.synchronize()
            what = f"K2 {site} {dtype}"
            e_fwd = _check(got[0], ref[0], dtype, what + " out")
            e_bwd = max(_check(a, b_, dtype, f"{what} {n}")
                        for n, a, b_ in zip(("dq", "dk", "dv"), got[1:], ref[1:]))
            with torch.no_grad():
                again = kern(q, k, v)
                other = k2(q, k, v, h, valid, rate, seed + 1)
                assert torch.equal(again, got[0]), what + ": not deterministic"
                assert not torch.equal(other, got[0]), what + ": seed ignored"
                _check(k2(q, k, v, h, valid, 0.0, seed), k1(q, k, v, h, valid),
                       dtype, what + ": rate 0 vs K1")
                out, lse, valid_u8 = k2_fwd(q, k, v, h, valid, rate, seed)
                bwd = lambda: k2_bwd(q, k, v, h, valid_u8, rate, seed,  # noqa: E731
                                     out, lse, g)
                assert all(torch.equal(a, b_) for a, b_ in zip(bwd(), got[1:])), \
                    what + ": backward alone differs"
                pf1 = cuda_ms(lambda: ref_fn(q, k, v))
                kf1 = cuda_ms(lambda: kern(q, k, v))
                kf2 = cuda_ms(lambda: kern(q, k, v))
                pf2 = cuda_ms(lambda: ref_fn(q, k, v))
                mask_ms = cuda_ms(lambda: keep_mask(seed, b, h, s, t, rate, "cuda"))
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out_p = ref_fn(qg, kg, vg)
            plain_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out_p, (qg, kg, vg), g, retain_graph=True)
            pbo1 = cuda_ms(plain_bwd, 5)
            kbo1 = cuda_ms(bwd, 5)
            kbo2 = cuda_ms(bwd, 5)
            pbo2 = cuda_ms(plain_bwd, 5)
            del out_p
            pb1 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            kb1 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            kb2 = cuda_ms(lambda: _fwd_bwd(kern, q, k, v, g), 5)
            pb2 = cuda_ms(lambda: _fwd_bwd(ref_fn, q, k, v, g), 5)
            lens = valid.sum(1).tolist() if valid is not None else [t]
            row = dict(site=site, B=b, S=s, T=t, H=h, D=d,
                       valid_keys=[min(lens), max(lens)],
                       dtype=str(dtype).replace("torch.", ""), rate=rate,
                       fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd,
                       fwd_ms=(kf1 + kf2) / 2, plain_fwd_ms=(pf1 + pf2) / 2,
                       plain_mask_ms=mask_ms,
                       bwd_ms=(kbo1 + kbo2) / 2,
                       plain_bwd_ms=(pbo1 + pbo2) / 2,
                       fwd_bwd_ms=(kb1 + kb2) / 2,
                       plain_fwd_bwd_ms=(pb1 + pb2) / 2)
            worst_fwd, worst_bwd = max(worst_fwd, e_fwd), max(worst_bwd, e_bwd)
            rows.append(row)
            print(f"K2 {site:31s} B={b} T={t} valid keys {min(lens)}-"
                  f"{max(lens)} {row['dtype']:8s} max|err| out {e_fwd:.3e} "
                  f"grads {e_bwd:.3e}; fwd kernel {row['fwd_ms']:.4f} ms plain "
                  f"{row['plain_fwd_ms']:.4f} ms (its keep mask alone "
                  f"{mask_ms:.4f} ms); bwd kernel {row['bwd_ms']:.4f} ms plain "
                  f"{row['plain_bwd_ms']:.4f} ms; fwd+bwd kernel "
                  f"{row['fwd_bwd_ms']:.4f} ms plain "
                  f"{row['plain_fwd_bwd_ms']:.4f} ms", flush=True)
            if masked == "rows":
                assert min(lens) <= 5 and len(set(lens)) >= 8, lens

    # uniform attention (q = k = 0), V = 1, dO = 1: out = row keep count
    # and dV = column keep count, each / (T (1 - rate)), per head
    _, s, t, h, d, _ = SHAPES[0]  # the decoder's self-attention at B 16
    zeros = torch.zeros(B, s, h * d, device="cuda")
    ones = torch.ones(B, t, h * d, device="cuda")
    out, _, _, dv = _fwd_bwd(
        lambda q, k, v: k2(q, k, v, h, None, rate, 77), zeros, zeros, ones,
        torch.ones_like(zeros))
    scale = t * (1.0 - rate)
    rows_k = (out[:, :, ::d] * scale).round().permute(0, 2, 1)  # (B, H, S)
    cols_k = (dv[:, :, ::d] * scale).round().permute(0, 2, 1)   # (B, H, T)
    mask = keep_mask(77, B, h, s, t, rate, "cuda")
    assert torch.equal(rows_k, mask.sum(-1).float()), "forward mask differs"
    assert torch.equal(cols_k, mask.sum(-2).float()), "backward mask differs"
    n = mask.numel()
    frac = rows_k.sum().item() / n
    sigma = ((1 - rate) * rate / n) ** 0.5
    print(f"K2 keep fraction {frac:.6f} (expected {1 - rate}, sigma "
          f"{sigma:.2e}, {abs(frac - (1 - rate)) / sigma:.2f} sigma); forward "
          f"row counts and backward column counts equal the plain mask's",
          flush=True)
    assert abs(frac - (1 - rate)) < 6 * sigma, frac
    return rows, worst_fwd, worst_bwd, frac


def phase_train_card_vs_cpu(cfg, build_segmenter):
    """One f32 R50 train step at dropout 0 on the card and on the CPU.

    At these random weights the gradients are ill-conditioned: the CPU
    differs from itself by about 3.5% in global relative L2 when only
    oneDNN is switched off (about 0.8% in the head: neck, decoder,
    projector), far over a fixed 1e-3 (cris_tpu_torch/grad_spread.py says
    why and takes the readings). Batch 8, not 2: BN over 2 values (the
    neck's txt_proj) leaves channels whose batch variance is below the
    rounding of E[x^2] - E[x]^2, and at one seed in three the CPU then
    differs from itself by 185% on the text encoder's gradient when only
    its thread count changes. So the loss is held to 1e-4, and the
    gradients to grad_spread's bars around the CPU's own spread (oneDNN
    off against on, measured here). Three planted faults must fail those
    bars: one decoder gradient short by the dropout scale (x 0.9),
    txt_proj's gradient dropped, and every head gradient 1% small."""
    import copy

    from cris_tpu_torch.grad_spread import (GLOBAL_SPREADS, TENSOR_SPREADS,
                                            grad_faults, grad_rel,
                                            step_grads, tensor_need)
    from cris_tpu_torch.profile_train import make_batches

    cfg = copy.deepcopy(cfg)
    cfg.dropout = 0.0
    base = build_segmenter(cfg, device="cpu", seed=0, train=True)
    batch = make_batches(1, 8, cfg.input_size, cfg.word_len, "cpu", seed=7)[0]
    ref_loss, ref, cpu_s, _ = step_grads(base, cfg, batch, "cpu")
    loss, got, _, _ = step_grads(base, cfg, batch, "cuda")
    _, alt, _, _ = step_grads(base, cfg, batch, "cpu", onednn=False)
    assert np.isfinite(loss), loss
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    names = list(ref)
    head = [n for n in names if not n.startswith("backbone.")]
    rel_grad, rel_head = grad_rel(got, ref, names), grad_rel(got, ref, head)
    spread, spread_head = grad_rel(alt, ref, names), grad_rel(alt, ref, head)
    need = tensor_need(got, ref, alt, names)
    faults = grad_faults(got, ref, alt, names, head)
    print(f"R50 f32 train step b8 card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f} (rel {rel_loss:.3e}); gradients' global rel L2 "
          f"{rel_grad:.3e}, head {rel_head:.3e} ({len(head)} of {len(names)} "
          f"tensors); the CPU against itself with oneDNN off: {spread:.3e}, "
          f"head {spread_head:.3e} (ratios {rel_grad / spread:.3f}, "
          f"{rel_head / spread_head:.3f}; bar {GLOBAL_SPREADS}); largest "
          f"tensor need {need:.3f} own spreads (bar {TENSOR_SPREADS}); "
          f"{len(faults)} out of bounds; CPU step {cpu_s:.1f} s", flush=True)
    assert rel_loss <= 1e-4, rel_loss
    assert not faults, faults[:5]
    planted = {
        "decoder.layers.2.self_attn.in_proj_weight x 0.9": {
            "decoder.layers.2.self_attn.in_proj_weight": 0.9},
        "neck.txt_proj gradients dropped": {
            n: 0.0 for n in names if n.startswith("neck.txt_proj.")},
        "every head gradient x 0.99": {n: 0.99 for n in head},
    }
    for label, scales in planted.items():
        assert scales and set(scales) <= set(names), label
        bad = dict(got, **{n: got[n] * f for n, f in scales.items()})
        caught = grad_faults(bad, ref, alt, names, head)
        print(f"planted fault '{label}': {len(caught)} bars fail", flush=True)
        assert caught, f"phase 7's bars let a planted fault pass: {label}"
    return rel_loss, rel_grad, rel_head, spread


def phase_train_bf16(cfg, build_segmenter, engine, counters, steps=8, b=32):
    """bf16-autocast R50 training at dropout 0.1 with K2 on the decoder."""
    assert cfg.dropout == 0.1 and cfg.precision == "bf16"
    model = build_segmenter(cfg, device="cuda", seed=0, train=True)
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=100)
    lrs = [g["lr"] for g in opt.param_groups]
    assert np.allclose(lrs, [1e-5, 1e-4], rtol=1e-12), lrs
    bns = {n: buf.clone() for n, buf in model.named_buffers()
           if n.endswith("running_mean")}
    from cris_tpu_torch.profile_train import make_batches

    batches = make_batches(steps, b, cfg.input_size, cfg.word_len, "cuda", seed=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = [], [], []
    for c in counters:
        c.launches = 0
    for i, batch in enumerate(batches):
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        metrics = engine.train_step(model, opt, sched, batch,
                                    engine.step_seed(0, i), torch.bfloat16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append([c.launches - n for c, n in zip(counters, before)])
        losses.append(metrics["loss"].item())
        assert np.isfinite(losses[-1]), (i, losses[-1])
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    moved = sum(not torch.equal(buf, bns[n]) for n, buf in model.named_buffers()
                if n in bns)
    assert moved == len(bns), (moved, len(bns))
    sites = 2 * cfg.num_layers  # self- and cross-attention per layer
    assert all(s == [sites, sites, 1] for s in per_step), per_step
    median = float(np.median(times[2:]))
    print(f"R50 bf16 train b{b}: losses {['%.4f' % x for x in losses]}; "
          f"launches per step (K2 fwd, K2 bwd, K1) {per_step[0]} in every "
          f"step; {moved} BN running means moved; group lrs {lrs}", flush=True)
    print(f"R50 bf16 train b{b} dropout 0.1: median step {median:.2f} ms "
          f"(steps 3-{steps}: {['%.2f' % x for x in times[2:]]}), peak memory "
          f"{peak:.2f} GiB, on {card_line()}", flush=True)
    return launches, median, peak, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cris_tpu_torch import engine
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.ops.kernels import (attention_dropout_backward,
                                            attention_dropout_forward,
                                            attention_dropout_plain,
                                            attention_plain, build,
                                            fused_attention_bse,
                                            fused_attention_bse_dropout,
                                            keep_mask)
    from cris_tpu_torch.serving import PredictService
    from cris_tpu_torch.utils import cris_r50_refcoco, tokenize

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build.load_library()
    log = build.library_path().with_suffix(".log")
    print(f"kernel build: {build.last_build_seconds:.1f} s -> "
          f"{build.library_path()}", flush=True)
    if log.is_file():
        print(log.read_text(), flush=True)

    rows, worst, ms, plain_ms = phase_kernel(fused_attention_bse, attention_plain)
    cfg = cris_r50_refcoco()
    phase_model(cfg, build_segmenter, tokenize)
    serving_launches, _ = phase_serving(cfg, PredictService, fused_attention_bse)
    k1_grad_rows, k1_grad_worst = phase_k1_backward(fused_attention_bse,
                                                    attention_plain)
    k2_rows, k2_fwd_worst, k2_bwd_worst, _ = phase_k2(
        fused_attention_bse_dropout, attention_dropout_forward,
        attention_dropout_backward, attention_dropout_plain,
        fused_attention_bse, keep_mask)
    phase_train_card_vs_cpu(cfg, build_segmenter)
    counters = [fused_attention_bse_dropout, attention_dropout_backward,
                fused_attention_bse]
    (k2_fwd_n, k2_bwd_n, k1_train_n), step_ms, peak, _ = phase_train_bf16(
        cfg, build_segmenter, engine, counters)

    # K2 at the train path's busiest site: self-attention, B 32, bf16
    main_k2 = next(r for r in k2_rows if r["site"].startswith(
        "decoder self-attn") and r["B"] == 32 and r["dtype"] == "bfloat16")
    k2_src = "cris_tpu_torch/csrc/attention_bse_dropout.cu"
    summary = {"kernels": [{
        "name": "fused_attention_bse",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/attention_bse.cu",
        "replaces": "cris_tpu/ops/pallas/attention.py:165",
        "launches": serving_launches + k1_train_n,
        "launches_by_path": {"serving": serving_launches,
                             "train": k1_train_n},
        "max_abs_err": max(worst, k1_grad_worst),
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_attention_bse_dropout (forward)",
        "route": "cuda",
        "source": k2_src,
        "replaces": "cris_tpu/ops/pallas/attention_train.py:218",
        "launches": k2_fwd_n,
        "max_abs_err": k2_fwd_worst,
        "ms": main_k2["fwd_ms"],
        "plain_ms": main_k2["plain_fwd_ms"],
    }, {
        "name": "fused_attention_bse_dropout (backward)",
        "route": "cuda",
        "source": k2_src,
        "replaces": "cris_tpu/ops/pallas/attention_train.py:248",
        "launches": k2_bwd_n,
        "max_abs_err": k2_bwd_worst,
        "ms": main_k2["bwd_ms"],
        "plain_ms": main_k2["plain_bwd_ms"],
    }]}
    print(json.dumps({"k1_shapes": rows, "k1_grad": k1_grad_rows,
                      "k2_shapes": k2_rows,
                      "train_bf16_b32": {"median_step_ms": step_ms,
                                         "peak_gib": peak}}), flush=True)
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
