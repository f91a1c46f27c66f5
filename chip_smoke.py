"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
1. card, versions, and the build of the CUDA kernels from cris_tpu_torch/csrc;
2. K1 against its plain PyTorch version at B = 16 on the main path's
   shapes and at head dims 16, 48 and 128, f32 (rtol = atol = 1e-4) and bf16 (rtol = atol = 2e-2, mean
   |err| < 2e-3), with CUDA-event times of both;
3. CRIS-R50 at 416 px (word_len 17, 3 decoder layers, seeded random
   weights): one f32 batch of 2 on the card against the same model on the
   CPU (relative L2 of the logits <= 1e-4, mask agreement at 0.35 >= 0.999);
4. three requests through PredictService.predict in bf16 autocast (1, 5
   and 16 sentences: buckets 1, 8 and 16); each mask has its image's
   shape, the probabilities are finite, and K1 launched exactly 7 times
   per device batch (3 decoder layers x 2 sites + attnpool).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.ops.kernels import attention_plain, build, fused_attention_bse
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
    print(f"K1 build: {build.last_build_seconds:.1f} s -> {build.library_path()}",
          flush=True)
    if log.is_file():
        print(log.read_text(), flush=True)

    rows, worst, ms, plain_ms = phase_kernel(fused_attention_bse, attention_plain)
    cfg = cris_r50_refcoco()
    phase_model(cfg, build_segmenter, tokenize)
    launches, _ = phase_serving(cfg, PredictService, fused_attention_bse)

    summary = {"kernels": [{
        "name": "fused_attention_bse",
        "route": "cuda",
        "source": "cris_tpu_torch/csrc/attention_bse.cu",
        "replaces": "cris_tpu/ops/pallas/attention.py:165",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps({"k1_shapes": rows}), flush=True)
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
