"""Where a served request's time goes, on one CUDA card.

    python3 -m cris_tpu_torch.profile_serving [--out FILE] [--unfolded]
        [--fused-bottleneck] [--fused-stem]

CRIS-R50 at 416 px (random weights from seed 0), bf16 autocast, as
``chip_smoke.py`` serves it: BN folded unless ``--unfolded``, with K5 and
K7 on the folded model when their switches are given. For buckets 1, 8 and 16 it times each stage
of ``PredictService.predict`` on the host clock over five requests
of a 640 x 480 image: the letterbox warp, the tokenizer, the device batch
(``Evaluator.predict_probs``: copies in, forward, sigmoid, resize, copy
out) and the inverse warps. Then it times the b16 forward alone with CUDA
events, and profiles three b16 forwards and one b16 request with
``torch.profiler``: device time by kernel, and the share of the wall
time in which the card ran anything. It prints the card's name and power
limit, and ``--out`` writes everything as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from . import serving
from .utils import cris_r50_refcoco

NVSMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
RUNS = 5  # requests per bucket
TOP = 15  # kernels listed per profile
STAGES = {"warp_image": "image warp", "tokenize": "tokenize",
          "inverse_warp_prediction": "inverse warps"}


def _timed(fn, name, totals):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        totals[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def stage_breakdown(service, image, runs=RUNS):
    """{bucket: {stage: [ms per request, ...]}} over ``runs`` requests."""
    totals = defaultdict(float)
    saved = {name: getattr(serving, name) for name in STAGES}
    for name, label in STAGES.items():
        setattr(serving, name, _timed(saved[name], label, totals))
    inner = service.evaluator.predict_probs
    service.evaluator.predict_probs = _timed(inner, "device batch", totals)
    result = {}
    try:
        for bucket, n in ((1, 1), (8, 5), (16, 16)):
            rows = defaultdict(list)
            for _ in range(runs):
                totals.clear()
                t0 = time.perf_counter()
                service.predict(image, ["the man on the left"] * n)
                rows["request"].append((time.perf_counter() - t0) * 1e3)
                for label, ms in totals.items():
                    rows[label].append(ms)
            result[bucket] = dict(rows)
    finally:
        for name, fn in saved.items():
            setattr(serving, name, fn)
        service.evaluator.predict_probs = inner
    return result


def busy_time(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def profile(fn, top=TOP):
    """Device time of ``fn`` by kernel, and the share of its wall time in
    which the card ran a kernel or a copy (the union of their intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the CPU ops that launched them carry the
    # same time again; the profiler's own buffer requests are not work
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    by_name = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    busy_us = busy_time(spans)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels": [{"name": name[:120], "launches": n, "device_ms": us / 1e3}
                        for name, (n, us) in rows]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--unfolded", action="store_true",
                        help="serve eval-form BN instead of the BN fold")
    parser.add_argument("--fused-bottleneck", action="store_true",
                        help="run the stride-1 tail bottlenecks as K5")
    parser.add_argument("--fused-stem", action="store_true",
                        help="run the stem and its pool as K7")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    card = subprocess.run(NVSMI, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    cfg = cris_r50_refcoco()
    switches = dict(fold_bn=not args.unfolded,
                    fused_bottleneck=args.fused_bottleneck,
                    fused_stem=args.fused_stem)
    service = serving.PredictService(cfg, device="cuda", max_batch=16,
                                     **switches)
    image = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "service": switches,
           "stages_ms": stage_breakdown(service, image)}
    for bucket, rows in out["stages_ms"].items():
        print(f"bucket {bucket}: " + "; ".join(
            f"{label} " + " ".join(f"{ms:.2f}" for ms in values)
            for label, values in rows.items()), flush=True)

    model, size = service.model, cfg.input_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn(16, 3, size, size, device="cuda", generator=gen)
    word = torch.randint(1, 49407, (16, cfg.word_len), device="cuda", generator=gen)

    @torch.no_grad()
    def forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return model(img, word)

    for _ in range(3):
        forward()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        forward()
    end.record()
    torch.cuda.synchronize()
    out["forward_b16_ms"] = start.elapsed_time(end) / 10
    print(f"b16 forward: {out['forward_b16_ms']:.3f} ms (CUDA events, mean of 10)",
          flush=True)

    out["profile_forward_x3"] = profile(lambda: [forward() for _ in range(3)])
    out["profile_request_b16"] = profile(
        lambda: service.predict(image, ["the man on the left"] * 16))
    for key in ("profile_forward_x3", "profile_request_b16"):
        prof = out[key]
        print(f"{key}: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, "
              f"busy share {prof['device_busy_share']:.4f}", flush=True)
        for row in prof["kernels"]:
            print(f"  {row['device_ms']:9.3f} ms {row['launches']:5d}x  {row['name']}",
                  flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
