"""The port's benchmark: ``bench.py``'s host metric and its three device
metrics on one CUDA card.

    python3 -m cris_tpu_torch.bench [--trials N] [--n1 N] [--n2 N]
    python3 -m cris_tpu_torch.bench --ab [--rounds N]
    python3 -m cris_tpu_torch.bench --ab rewrites [--rounds N]
    python3 -m cris_tpu_torch.bench --int8 [--trials N] [--n1 N] [--n2 N]

One JSON line per metric, under ``bench.py``'s names, in images per
second: ``{"metric", "value", "unit", "trials", "spread", "card"}``.

- ``host_input_pipeline_640x480``, first, as ``bench.py:352-383`` prints
  it (``data/host_bench.py``): 48 distinct 640 x 480 JPEG images with PNG
  masks preprocessed to 416^2, the best of 2 runs on the host clock. Its
  value is the native data plane's img/s on all the host's threads; beside
  it the plane on one thread, the per-sample numpy path (16 images),
  ``vs_baseline`` (native over per-sample), ``os.cpu_count()`` and the CPU
  model. After the R50 eval metric, ``host_cores_to_feed_r50_eval``: the
  cores of the plane (at its one-thread rate) that keep up with this
  run's R50 eval rate. A failure of the host metric prints an ``error``
  line; the device metrics still run, and the run exits non-zero.

- ``cris_r50_eval_throughput_416px_b32``: the eval step that
  ``bench.py:174-182`` scans. The BN-folded CRIS-R50
  (``checkpoint.fold_batchnorm`` at the input size, then
  ``build_segmenter(fold_bn=True, pos_grid=13)``) runs under bf16
  autocast, then sigmoid in f32 and a bicubic ``align_corners`` resize
  to 416 x 416 (``Evaluator.device_probs``). The probabilities are summed
  into one device scalar, which the host reads once per loop. K5 and K7
  stay off, as the JAX package's env gates default. The port has none of
  graph rewrites (the s2d stem, the fused pools, the upsample folds) stay
  off until ``--ab rewrites`` decides, so this is not the graph that
  ``bench.py`` times.
- ``cris_r50_train_throughput_416px_b32``: ``engine.train_step`` with
  ``make_optimizer`` on ``bench.py:203-204``'s settings, bf16 autocast,
  dropout 0.1, dropout seeds ``engine.step_seed(42, i)``. Nothing in the
  loop waits for the card; the losses are checked finite after it.
- ``cris_r101_eval_throughput_416px_b32``: the eval step at R101.
- ``--int8``: ``bench.py:429-466``'s pair instead,
  ``cris_r50_eval_int8_throughput_416px_b32`` and ``_b16``: the eval
  step at ``precision: int8`` (bf16 autocast, the three rewrites on, the
  int8 sites on K8 with ``min_ch`` 64, pooled and upfold sites at 256),
  its scales calibrated on the bench's own batches as ``bench.py:129-150``
  does (2 batches of 8 N(0, 1) images, seed 100). Each line also gives
  K8's launches per batch.

Weights are random from seed 0 (``bench.py:117``). Batches are made on
the device from a ``torch.Generator`` seed (images N(0, 1), token ids in
[1, 49000) with no padding, masks U(0, 1) > 0.5, as ``bench.py:163-171``
and ``:209-219``), each loop length its own, before any clock starts.

Method: ``bench.py``'s marginal rate. Both loop lengths run once to warm
up (the first call builds the CUDA kernels and fills K5's and K7's plan
caches, and cuDNN picks its algorithms). Each trial then times a loop of
n1 and one of n2 batches, with CUDA events around the whole loop and a
synchronise after it; its rate is B (n2 - n1) / (T2 - T1), which cancels
what a loop costs once. The value is the median over the trials, the
spread (max - min) / median. A trial whose long loop was not slower
times both loops again, each length keeping its minimum, as ``bench.py``
retries a noisy pair, up to ``ATTEMPTS`` times; if T2 <= T1 still, no
rate exists and the metric fails. No CUDA graphs, ``torch.compile`` or ``cudnn.benchmark``: the
entry points run without them. Before each metric's line, a line gives
the device-busy share of one loop of n2 batches under ``torch.profiler``
(``profile_serving.profile``): near 1 the card sets the number, well
below it the host does.

``--ab rewrites`` runs the R50 bf16 eval step at the bench's batch on two
arms, the graph rewrites off and on (the folded model, K5 and K7 off),
in turns off on on off per round; the rewrites become the bf16 default
only if "on" beats "off" in every round (mean over its two turns) and
its median gain exceeds the larger of the two arms' (max - min).

``--ab`` runs the R50 eval step at the bench's batch on four arms, each
model built once: (a) folded; (b) + K5 on every tail; (c) + K5 on the
narrow tails only (``bottleneck_takes``'s rule "narrow"); (d) the better
of (b) and (c) in one pilot turn each, + K7. The arms run in turns,
a b c d d c b a per round, each turn one marginal measurement with its
K5 and K7 launches per batch, and every turn is printed. Then the rules
are applied: an arm beats another when its mean over its two turns is
higher in every round; the gate keeps "narrow" only if (c) beats (b); a
switch turns on by default only if its arm beats the arm without it and
the median gain exceeds the larger of the two arms' (max - min).

Of the device metrics the eval metric runs first; if it fails, the run
exits non-zero. The other two print an ``error`` line and the run goes
on. It runs on the card unless ``--device cpu`` is given (the tests, at a
tiny size); with no card it exits non-zero, and it never falls back to
the CPU on its own.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence

import torch

from . import engine
from .checkpoint import calibrate_act_scales, fold_batchnorm, set_act_scales
from .data.host_bench import cores_to_feed, measure_host_pipeline
from .engine import Evaluator
from .models import QuantConfig, build_segmenter, resolve_dtype
from .ops.kernels import fused_bottleneck, fused_stem_pool, int8_conv
from .profile_serving import NVSMI, profile
from .utils import CfgNode, config_for

BATCH, N1, N2, TRIALS, ROUNDS = 32, 2, 12, 5, 5
# a marginal turn's attempts before it refuses, as bench.py:277 retries
ATTEMPTS = 8
WORD_HIGH = 49000  # token ids in [1, WORD_HIGH), as bench.py draws them
R50, R101 = "config/refcoco/cris_r50.yaml", "config/refcoco/cris_r101.yaml"
# (metric, step, config); the first must succeed
METRICS = (("cris_r50_eval_throughput_416px_b32", "eval", R50),
           ("cris_r50_train_throughput_416px_b32", "train", R50),
           ("cris_r101_eval_throughput_416px_b32", "eval", R101))
# bench.py:203-204's optimizer
TRAIN_OPT = dict(base_lr=1e-4, lr_multi=0.1, milestones=[35], lr_decay=0.1,
                 weight_decay=0.0, max_norm=0.0)
# bench.py:429-466's int8 pair: (metric, config, batch)
INT8_METRICS = (("cris_r50_eval_int8_throughput_416px_b32", R50, 32),
                ("cris_r50_eval_int8_throughput_416px_b16", R50, 16))
# bench.py:129-150: the int8 sites' gate and the calibration batches
INT8_QUANT = QuantConfig(min_ch=64)
CALIB_BATCHES, CALIB_B, CALIB_SEED = 2, 8, 100
ARMS = {"a": {}, "b": {"fused_bottleneck": "every"},
        "c": {"fused_bottleneck": "narrow"}}
HOST_METRIC = "host_input_pipeline_640x480"
# bench.py:363's sizes of the host measurement
HOST_ARGS = dict(n_images=48, repeats=2, python_images=16)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(NVSMI, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def make_batches(n: int, b: int, size: int, word_len: int, device,
                 seed: int, masks: bool = False) -> List[Dict]:
    """n seeded batches made on ``device``: image (b, 3, size, size)
    N(0, 1), word (b, word_len) ids in [1, WORD_HIGH) with no padding, and
    with ``masks`` mask (b, 1, size, size) = U(0, 1) > 0.5 as float."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {
            "image": torch.randn(b, 3, size, size, device=device,
                                 generator=gen),
            "word": torch.randint(1, WORD_HIGH, (b, word_len), device=device,
                                  generator=gen)}
        if masks:
            batch["mask"] = (torch.rand(b, 1, size, size, device=device,
                                        generator=gen) > 0.5).float()
        out.append(batch)
    return out


def folded_state(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The random weights of ``seed``, BN folded at the input size."""
    sd = build_segmenter(cfg, device="cpu", seed=seed).state_dict()
    return fold_batchnorm(sd, cfg.input_size)


def eval_model(cfg, device, folded_sd, **switches) -> torch.nn.Module:
    """The folded eval model on ``device`` (K5/K7 ``switches`` off unless
    given)."""
    model = build_segmenter(cfg, device="meta", fold_bn=True,
                            pos_grid=cfg.input_size // 32, **switches)
    model.load_state_dict(folded_sd, assign=True)
    return model.to(device)


def calibrate(model: torch.nn.Module, cfg, device,
              pct: float = 0.0) -> torch.nn.Module:
    """Give ``model``'s int8 sites the scales of a bf16 calibration on the
    bench's own batches (``bench.py:129-150``; with ``pct`` at that
    percentile of |x|)."""
    calib = [(b["image"], b["word"]) for b in make_batches(
        CALIB_BATCHES, CALIB_B, cfg.input_size, cfg.word_len, device,
        CALIB_SEED)]
    set_act_scales(model, calibrate_act_scales(model, calib, pct=pct,
                                               dtype=torch.bfloat16))
    return model


def int8_model(cfg, device) -> torch.nn.Module:
    """The R50 eval model at precision int8 with its sites' scales
    calibrated on the bench's own batches."""
    cfg = CfgNode({**cfg, "precision": "int8"})
    return calibrate(eval_model(cfg, device, folded_state(cfg),
                                quant=INT8_QUANT), cfg, device)


def eval_loop(model, cfg) -> Callable[[Sequence[Dict]], torch.Tensor]:
    """batches -> the sum of their probabilities, one device scalar."""
    ev = Evaluator(model, cfg.input_size,
                   resolve_dtype(cfg.get("precision", "bf16")))

    def run(batches):
        acc = torch.zeros((), device=ev.device)
        for batch in batches:
            acc = acc + ev.device_probs(batch["image"], batch["word"]).sum()
        return acc
    return run


def train_loop(cfg, device) -> Callable[[Sequence[Dict]], torch.Tensor]:
    """batches -> their losses (device tensor), one train step each, on
    the model of seed 0 and its optimizer, which keep their state."""
    model = build_segmenter(cfg, device=device, seed=0, train=True)
    opt, sched = engine.make_optimizer(model, CfgNode({**cfg, **TRAIN_OPT}),
                                       steps_per_epoch=1000)
    dtype = resolve_dtype(cfg.get("precision", "bf16"))
    step = itertools.count()

    def run(batches):
        return torch.stack([
            engine.train_step(model, opt, sched, batch,
                              engine.step_seed(42, next(step)), dtype)["loss"]
            for batch in batches])
    return run


def timed(run, batches, device: torch.device):
    """(seconds, output) of one loop: CUDA events around it on the card,
    the host clock on the CPU; the output is checked finite after the
    synchronise."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = run(batches)
        end.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = run(batches)
        seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError(f"a loop of {len(batches)} batches gave "
                                 f"non-finite output {out}")
    return seconds, out


def marginal_rate(b: int, n1: int, n2: int, t1: float, t2: float) -> float:
    """B (n2 - n1) / (T2 - T1) in images per second; refuses T2 <= T1."""
    if not n2 > n1:
        raise ValueError(f"need n2 > n1, got {n1}, {n2}")
    if not t2 > t1:
        raise ValueError(f"{n2} batches took {t2:.6f} s, no longer than "
                         f"{n1} ({t1:.6f} s): no marginal rate")
    return b * (n2 - n1) / (t2 - t1)


def turn(run, short, long, b, device, attempts: int = ATTEMPTS) -> float:
    """One marginal measurement, as ``bench.py:247-306`` takes it: a loop
    of each length, timed; while the long loop was not slower, both are
    timed again, each length keeping its minimum, up to ``attempts``
    times; then ``marginal_rate`` of the minima, which refuses T2 <= T1."""
    t1 = t2 = float("inf")
    for attempt in range(1, attempts + 1):
        t1 = min(t1, timed(run, short, device)[0])
        t2 = min(t2, timed(run, long, device)[0])
        if t2 > t1 or attempt == attempts:
            return marginal_rate(b, len(short), len(long), t1, t2)


def measure(run, short, long, b: int, trials: int, device) -> Dict:
    """Warm both loop lengths up, then ``trials`` marginal rates: their
    median ("value"), the rates ("trials") and (max - min) / median
    ("spread")."""
    for batches in (short, long):
        timed(run, batches, device)
    rates = [turn(run, short, long, b, device) for _ in range(trials)]
    value = statistics.median(rates)
    return {"value": value, "trials": rates,
            "spread": (max(rates) - min(rates)) / value}


def run_metric(name: str, step: str, cfg, device: torch.device, b: int,
               n1: int, n2: int, trials: int, seed: int = 0) -> Dict:
    """One metric: its model, batches and marginal rates, then (on the
    card) the busy share of one loop of n2 batches, printed first.
    "batches" counts every batch the model ran."""
    masks = step == "train"
    short, long = (make_batches(n, b, cfg.input_size, cfg.word_len, device,
                                seed + k, masks)
                   for k, n in ((1000, n1), (2000, n2)))
    if step == "train":
        run = train_loop(cfg, device)
    elif step == "int8":
        run = eval_loop(int8_model(cfg, device),
                        CfgNode({**cfg, "precision": "int8"}))
    else:
        run = eval_loop(eval_model(cfg, device, folded_state(cfg)), cfg)
    k8_before = int8_conv.launches
    result = measure(run, short, long, b, trials, device)
    result["batches"] = (n1 + n2) * (trials + 1)
    if device.type == "cuda":
        prof = profile(lambda: run(long), top=0)
        result["batches"] += n2
        print(json.dumps({"metric": name, "loop_batches": n2,
                          "wall_ms": prof["wall_ms"],
                          "device_busy_ms": prof["device_busy_ms"],
                          "device_busy_share": prof["device_busy_share"],
                          "card": card(device)}), flush=True)
    result["k8_launches"] = int8_conv.launches - k8_before
    return result


def run_host_metric(device: torch.device) -> Dict:
    """The host metric's line, printed; on a failure an ``error`` line is
    printed and the exception raised."""
    try:
        r = measure_host_pipeline(**HOST_ARGS)
    except Exception as e:
        print(json.dumps({"metric": HOST_METRIC, "error": repr(e)[:200]}),
              flush=True)
        raise
    line = {"metric": HOST_METRIC, "value": r["native_img_s"], "unit": "img/s",
            "native_1thread_img_s": r["native_1thread_img_s"],
            "per_sample_img_s": r["python_img_s"],
            "vs_baseline": r["native_img_s"] / r["python_img_s"],
            "native_threads": r["native_threads"],
            "prewarped_img_s": r["prewarped_img_s"],
            "host_cores": r["host_cores"], "cpu_model": r["cpu_model"],
            "images": r["n_images"], "card": card(device)}
    print(json.dumps(line), flush=True)
    return line


def print_cores_to_feed(host: Dict, eval_img_s: float) -> None:
    """The plane's cores (at its one-thread rate) that feed this run's R50
    eval rate."""
    print(json.dumps({
        "metric": "host_cores_to_feed_r50_eval",
        "value": cores_to_feed(eval_img_s, host["native_1thread_img_s"]),
        "unit": "cores", "r50_eval_img_s": eval_img_s,
        "native_1thread_img_s": host["native_1thread_img_s"],
        "host_cores": host["host_cores"], "cpu_model": host["cpu_model"]}),
        flush=True)


def free(device: torch.device) -> None:
    """Return the last metric's memory before the next one."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def launches() -> tuple:
    return fused_bottleneck.launches, fused_stem_pool.launches


def beats(per_round: Dict[str, List[float]], x: str, y: str) -> bool:
    return all(p > q for p, q in zip(per_round[x], per_round[y]))


def decide(turns: Sequence[Dict], k5_arm: str) -> Dict:
    """The A/B's rules on its turns ({"round", "arm", "img_s"}): the K5
    tail rule, and whether each switch clears the bar, K5 against (a) on
    the arm of the rule, K7 against d's K5 arm."""
    rounds = sorted({t["round"] for t in turns})
    rates = {a: [t["img_s"] for t in turns if t["arm"] == a] for a in "abcd"}
    per_round = {a: [statistics.mean(t["img_s"] for t in turns
                                     if t["arm"] == a and t["round"] == r)
                     for r in rounds] for a in "abcd"}
    median = {a: statistics.median(v) for a, v in rates.items()}
    width = {a: max(v) - min(v) for a, v in rates.items()}

    def clears(x, y):
        return (beats(per_round, x, y)
                and median[x] - median[y] > max(width[x], width[y]))

    rule = "narrow" if beats(per_round, "c", "b") else "every"
    k5 = {"every": "b", "narrow": "c"}[rule]
    return {"median_img_s": median, "max_minus_min": width,
            "per_round_mean": per_round, "tail_rule": rule,
            "fused_bottleneck_on": clears(k5, "a"),
            "fused_stem_on": clears("d", k5_arm), "d_k5_arm": k5_arm}


def ab_rewrites(cfg, device: torch.device, b: int, n1: int, n2: int,
                rounds: int, seed: int = 0) -> Dict:
    """The bf16 folded eval step with the graph rewrites off and on, in
    turns off on on off, ``rounds`` rounds; every turn printed, then the
    decision (``rewrites_on``: whether they become the bf16 default)."""
    short, long = (make_batches(n, b, cfg.input_size, cfg.word_len, device,
                                seed + k) for k, n in ((1000, n1), (2000, n2)))
    sd = folded_state(cfg)
    line = {"card": card(device), "batch": b, "n1": n1, "n2": n2}
    runs = {}
    for arm in ("off", "on"):
        runs[arm] = eval_loop(eval_model(cfg, device, sd,
                                         rewrites=arm == "on"), cfg)
        for batches in (short, long):
            timed(runs[arm], batches, device)
    turns = []
    for r in range(rounds):
        for arm in ("off", "on", "on", "off"):
            row = {"arm": arm, "round": r,
                   "img_s": turn(runs[arm], short, long, b, device), **line}
            print(json.dumps(row), flush=True)
            turns.append(row)
    rates = {a: [t["img_s"] for t in turns if t["arm"] == a]
             for a in ("off", "on")}
    per_round = {a: [statistics.mean(t["img_s"] for t in turns
                                     if t["arm"] == a and t["round"] == r)
                     for r in range(rounds)] for a in ("off", "on")}
    median = {a: statistics.median(v) for a, v in rates.items()}
    width = {a: max(v) - min(v) for a, v in rates.items()}
    on = (beats(per_round, "on", "off")
          and median["on"] - median["off"] > max(width.values()))
    decision = {"median_img_s": median, "max_minus_min": width,
                "per_round_mean": per_round, "rewrites_on": on,
                "gain": median["on"] / median["off"] - 1.0}
    print(json.dumps(decision), flush=True)
    return {"ab": decision, "turns": turns, **line}


def ab(cfg, device: torch.device, b: int, n1: int, n2: int, rounds: int,
       seed: int = 0) -> Dict:
    """Arms (a)-(d) in turns a b c d d c b a, ``rounds`` rounds; every
    turn printed, then the decisions."""
    short, long = (make_batches(n, b, cfg.input_size, cfg.word_len, device,
                                seed + k) for k, n in ((1000, n1), (2000, n2)))
    sd = folded_state(cfg)
    line = {"card": card(device), "batch": b, "n1": n1, "n2": n2}
    runs = {}

    def add(arm, switches):
        runs[arm] = eval_loop(eval_model(cfg, device, sd, **switches), cfg)
        for batches in (short, long):
            timed(runs[arm], batches, device)

    def one_turn(arm, rnd):
        before, ran = launches(), []

        def counted(batches):  # a retried turn runs more batches
            ran.append(len(batches))
            return runs[arm](batches)

        rate = turn(counted, short, long, b, device)
        k5, k7 = (a - z for a, z in zip(launches(), before))
        row = {"arm": arm, "round": rnd, "img_s": rate,
               "k5_per_batch": k5 / sum(ran),
               "k7_per_batch": k7 / sum(ran), **line}
        print(json.dumps(row), flush=True)
        return row

    for arm, switches in ARMS.items():
        add(arm, switches)
    pilot = {arm: one_turn(arm, "pilot")["img_s"] for arm in "bc"}
    k5_arm = max(pilot, key=pilot.get)
    add("d", {**ARMS[k5_arm], "fused_stem": True})
    turns = [one_turn(arm, r) for r in range(rounds) for arm in "abcddcba"]
    out = {"ab": decide(turns, k5_arm), "turns": turns, **line}
    print(json.dumps(out["ab"]), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; never chosen for you")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--n1", type=int, default=N1)
    parser.add_argument("--n2", type=int, default=N2)
    parser.add_argument("--trials", type=int, default=TRIALS)
    parser.add_argument("--ab", nargs="?", const="kernels",
                        choices=("kernels", "rewrites"),
                        help="the K5/K7 switch A/B (default) or the graph "
                             "rewrites' A/B on the R50 eval step")
    parser.add_argument("--int8", action="store_true",
                        help="the int8 pair instead of the three metrics")
    parser.add_argument("--rounds", type=int, default=ROUNDS,
                        help="rounds of the A/B (a b c d d c b a each)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for the CPU)",
              file=sys.stderr)
        return 1
    print(f"card: {card(device)}; torch {torch.__version__}", flush=True)
    if args.ab:
        run_ab = ab_rewrites if args.ab == "rewrites" else ab
        run_ab(config_for(R50), device, args.batch, args.n1, args.n2,
               args.rounds)
        return 0
    if args.int8:
        for name, path, b in INT8_METRICS:
            result = run_metric(name, "int8", config_for(path), device, b,
                                args.n1, args.n2, args.trials)
            free(device)
            print(json.dumps({"metric": name, "value": result["value"],
                              "unit": "img/s", "trials": result["trials"],
                              "spread": result["spread"],
                              "k8_per_batch": result["k8_launches"]
                              / result["batches"],
                              "card": card(device)}), flush=True)
        return 0
    try:
        host = run_host_metric(device)
    except Exception:  # noqa: BLE001 -- printed; the device metrics go on
        host = None
    for i, (name, step, path) in enumerate(METRICS):
        try:
            result = run_metric(name, step, config_for(path), device,
                                args.batch, args.n1, args.n2, args.trials)
        except Exception as e:  # noqa: BLE001 -- the later metrics go on
            if i == 0:
                raise
            print(json.dumps({"metric": name, "error": repr(e)[:200]}),
                  flush=True)
            continue
        finally:
            free(device)
        print(json.dumps({"metric": name, "value": result["value"],
                          "unit": "img/s", "trials": result["trials"],
                          "spread": result["spread"],
                          "card": card(device)}), flush=True)
        if i == 0 and host is not None:
            print_cores_to_feed(host, result["value"])
    return 0 if host is not None else 1


if __name__ == "__main__":
    sys.exit(main())
