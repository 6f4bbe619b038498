#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qbn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout: it builds the port's CUDA kernel with nvcc
and drives the port's main path, INT8 Monte-Carlo evaluation of the trained
Bayes-by-backprop ResNet-18 (examples/campaign/bbb-cifar-a_7_w_8-seed1) at
full width, on CIFAR-shaped inputs made from --seed with numpy. Phases, in
order, each printing its seconds:

  1. device   the card's name and power limit (nvidia-smi) and torch's name
  2. build    nvcc of csrc/sample_weights.cu, with its register/spill report
  3. kernel   the posterior-draw kernel against its plain PyTorch version:
              bitwise with explicit noise at all 21 flagship layers (S=100)
              and on a pack holding a layer over 1024 rows of 512; with its
              own Philox normals, code histograms against the plain version
              fed torch.randn, and the moments of 10^7 of its normals
  4. conv     the port's library convolutions at every conv shape of the
              net at B=256, S=100: integral, equal to a float64 conv of
              NCHW copies and to int64 window sums at sampled outputs
  5. main     `evaluate` on the checkpoint (read by the port's own reader),
              the kernel's launch count per batch, the kernel path against
              the plain-draw path with the same explicit noise (identical
              int8 codes at every up_to cut), and the card against the CPU
              path on a small input
  6. profile  one batch under torch.profiler: device time by kernel and
              the device's idle share
  7. times    the draw kernel against the plain version and its bound

Any failed check raises and the run exits non-zero. The last lines are a
`{"kernels": [...]}` JSON object and `{"ok": true, "device": {...}}`.
Needs one card; exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qbn_tpu_torch.convert import to_device
from qbn_tpu_torch.evaluation.mc import (
    draw_sampled_weights, evaluate, mc_predict, plan_layers, presample_plan,
    sampled_tree)
from qbn_tpu_torch.models.architectures import CUTS
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.ops import _build
from qbn_tpu_torch.ops import sample_weights as sw
from qbn_tpu_torch.ops.integer import _CENTERED_K, conv_sum, no_tf32
from qbn_tpu_torch.training.metrics import cls_metrics_compute

ROOT = os.path.dirname(os.path.abspath(__file__))
EXP = os.path.join(ROOT, "examples", "campaign", "bbb-cifar-a_7_w_8-seed1")
BATCHES, BATCH, SAMPLES = 3, 256, 100     # the main path, as bench.py runs it
KERNEL_SOURCE = "qbn_tpu_torch/csrc/sample_weights.cu"
KERNEL_REPLACES = "qbn_tpu/ops/pallas/sample_weights.py:356"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) operations/s, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per drawn code: the quantise chain of draw_code in the
# kernel (26: two dequants, the noise quantise, the quantised multiply and
# add, the clips and the convert) plus 4 for the Box-Muller normal
# amortised over its pair (the Philox integer rounds are not counted).
OPS_PER_CODE = 30


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        print(f"phase {self.name} seconds {dt:.3f}", flush=True)
        return False


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_draw(layers, noise):
    return [sw.sample_weights_plain(w, s, qp, e, lo, hi)
            for (w, s, qp, lo, hi), e in zip(layers, noise)]


def phase_kernel(state, plan, samples, seed, dev):
    """Kernel against plain: returns the largest code difference seen."""
    g = torch.Generator(device=dev).manual_seed(seed)
    layers = plan_layers(state, plan)
    pack = sw.pack_layers(layers, samples)
    noise = [torch.randn((samples,) + tuple(w.shape), generator=g,
                         device=dev) for (w, *_r) in layers]
    got = sw.draw_layers(pack, noise=noise)
    want = plain_draw(layers, noise)
    max_err = 0
    for (path, _lo, _hi), a, b in zip(plan, got, want):
        check(a.shape == b.shape and a.dtype == torch.int8,
              f"{path}: shape/dtype {a.shape} {a.dtype}")
        err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"{path}: kernel differs from plain by {err} codes")
    n_codes = sum(a.numel() for a in got)
    print(f"explicit noise: {len(got)} layers, {n_codes} codes, "
          f"max |kernel - plain| = {max_err}")
    check(n_codes == samples * 1571592, f"code count {n_codes}")

    # draw_all_layers's case: a pack with a layer over 1024 rows of 512
    # lanes (LeNet fc1, 2450 x 500) beside flagship layers
    w_big = torch.randint(-128, 128, (2450, 500), generator=g, device=dev,
                          dtype=torch.int8)
    s_big = torch.randint(-128, 128, (2450, 500), generator=g, device=dev,
                          dtype=torch.int8)
    mixed = [layers[0], (w_big, s_big, layers[5][2], -8, 7), layers[-1]]
    check(math.ceil(2450 * 500 / 512) > 1024, "big layer too small")
    noise_m = [torch.randn((samples,) + tuple(l[0].shape), generator=g,
                           device=dev) for l in mixed]
    got_m = sw.draw_layers(sw.pack_layers(mixed, samples), noise=noise_m)
    for a, b in zip(got_m, plain_draw(mixed, noise_m)):
        err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"mixed pack: kernel differs by {err} codes")
    print("pack with a 2393-row layer (w_lo/w_hi -8/7): bitwise equal")

    # Philox mode: the kernel's codes against the plain version fed
    # torch.randn. The means are shared, only the noise differs, so the
    # histograms of two honest draws differ by sampling noise alone:
    # E[TV] <= 0.5 * sqrt(2 * K / N) for K occupied codes and N draws;
    # the bound is three times that.
    gen = torch.Generator().manual_seed(seed + 1)
    got_p = sw.draw_layers(pack, generator=gen)
    ref_p = plain_draw(layers, [torch.randn_like(e) for e in noise])
    worst = 0.0
    for (path, _lo, _hi), a, b in zip(plan, got_p, ref_p):
        ha = torch.bincount(a.reshape(-1).to(torch.int64) + 128,
                            minlength=256).double()
        hb = torch.bincount(b.reshape(-1).to(torch.int64) + 128,
                            minlength=256).double()
        n = a.numel()
        k = int(((ha + hb) > 0).sum())
        tv = 0.5 * float((ha - hb).abs().sum()) / n
        bound = 3 * 0.5 * math.sqrt(2 * k / n)
        worst = max(worst, tv / bound)
        check(tv <= bound, f"{path}: code histogram TV {tv:.5f} > {bound:.5f}")
    print(f"philox codes vs plain+randn: worst TV / bound = {worst:.3f}")

    # The kernel's own normals: with unit qparams the code IS eps_q =
    # clip(round(eps * 127/3), -128, 127). 10^7 of them against the exact
    # law of a quantised, clipped N(0, 1).
    ns = 3.0 / 127.0
    one = {"w_scale": 1.0, "w_zp": 0.0, "std_scale": 1.0, "std_zp": 0.0,
           "mul_scale": ns, "mul_zp": 0.0, "add_scale": ns, "add_zp": 0.0}
    one = {k: torch.tensor(v, dtype=torch.float32, device=dev)
           for k, v in one.items()}
    n_el = 100_000
    w0 = torch.zeros(n_el, dtype=torch.int8, device=dev)
    s1 = torch.ones(n_el, dtype=torch.int8, device=dev)
    eq = sw.sample_weights_int8(w0, s1, one, 100, -128, 127,
                                generator=gen).to(torch.float64)
    n = eq.numel()
    ks = torch.arange(-128, 128, dtype=torch.float64)
    cdf = lambda z: 0.5 * (1 + torch.erf(z / math.sqrt(2)))  # noqa: E731
    hi = torch.where(ks == 127, torch.tensor(math.inf, dtype=torch.float64),
                     (ks + 0.5) * ns)
    lo = torch.where(ks == -128, torch.tensor(-math.inf,
                                              dtype=torch.float64),
                     (ks - 0.5) * ns)
    p = cdf(hi) - cdf(lo)
    mean_exp = float((p * ks * ns).sum())
    std_exp = math.sqrt(float((p * (ks * ns - mean_exp) ** 2).sum()))
    x = eq * ns
    mean, std = float(x.mean()), float(x.std())
    mean_tol = 5 * std_exp / math.sqrt(n)
    std_tol = 5 * std_exp / math.sqrt(2 * n)
    print(f"kernel eps over {n} draws: mean {mean:.6f} (expect "
          f"{mean_exp:.6f} +- {mean_tol:.6f}), std {std:.6f} (expect "
          f"{std_exp:.6f} +- {std_tol:.6f})")
    check(abs(mean - mean_exp) <= mean_tol, "kernel eps mean")
    check(abs(std - std_exp) <= std_tol, "kernel eps std")
    h = torch.bincount(eq.reshape(-1).to(torch.int64).cpu() + 128,
                       minlength=256).double() / n
    tv = 0.5 * float((h - p).abs().sum())
    tv_bound = 3 * 0.5 * math.sqrt(2 * int((p > 1e-9).sum()) / n)
    print(f"kernel eps histogram TV vs exact law {tv:.6f} "
          f"(bound {tv_bound:.6f})")
    check(tv <= tv_bound, "kernel eps histogram")
    # draws of neighbouring elements and neighbouring samples uncorrelated
    for name, a, b in (("element", x[:, :-1], x[:, 1:]),
                       ("sample", x[:-1], x[1:])):
        a = a.reshape(-1) - a.mean()
        b = b.reshape(-1) - b.mean()
        r = float((a * b).mean() / (a.std() * b.std()))
        print(f"lag-1 correlation across {name}s {r:.6f}")
        check(abs(r) <= 5 / math.sqrt(a.numel()), f"{name} correlation")
    return max_err


CONV_SHAPES = [
    # (name, cin, cout, kernel, stride, input size, shared x)
    ("stem", 3, 24, 3, 1, 32, True),
    ("stage0 3x3", 24, 24, 3, 1, 32, False),
    ("stage1 3x3/2", 24, 48, 3, 2, 32, False),
    ("stage1 1x1/2", 24, 48, 1, 2, 32, False),
    ("stage1 3x3", 48, 48, 3, 1, 16, False),
    ("stage2 3x3/2", 48, 96, 3, 2, 16, False),
    ("stage2 1x1/2", 48, 96, 1, 2, 16, False),
    ("stage2 3x3", 96, 96, 3, 1, 8, False),
    ("stage3 3x3/2", 96, 192, 3, 2, 8, False),
    ("stage3 1x1/2", 96, 192, 1, 2, 8, False),
    ("stage3 3x3", 192, 192, 3, 1, 4, False),
]


def _spot_check(x, w, stride, pad, groups, out, n=64, seed=0):
    """n outputs of a conv recomputed as int64 window sums, independently
    of any library convolution."""
    g = torch.Generator().manual_seed(seed)
    b, ho, wo, o = out.shape
    cin, k = w.shape[1], w.shape[2]
    xp = F.pad(x.to(torch.int64), (0, 0, pad, pad, pad, pad))
    for _ in range(n):
        bi, hi, wi, oi = (int(torch.randint(0, m, (), generator=g))
                          for m in (b, ho, wo, o))
        gi = oi // (o // groups)
        win = xp[bi, hi * stride:hi * stride + k, wi * stride:wi * stride + k,
                 gi * cin:(gi + 1) * cin]
        ref = int((win * w[oi].to(torch.int64).permute(1, 2, 0)).sum())
        check(float(out[bi, hi, wi, oi]) == ref,
              f"spot check at {(bi, hi, wi, oi)}: {float(out[bi, hi, wi, oi])}"
              f" != {ref}")


def phase_conv(batch, samples, seed, dev):
    """The port's exact conv sums (and window sums where the net takes
    them) at every conv shape: integral, equal to a float64 convolution
    of NCHW-contiguous copies, and equal to int64 window sums at sampled
    outputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, cin, cout, k, stride, hw, shared in CONV_SHAPES:
        groups = 1 if shared else samples
        xc = cin if shared else samples * cin
        x = torch.randint(-127, 128, (batch, hw, hw, xc), generator=g,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (samples * cout, cin, k, k),
                          generator=g, device=dev).float()
        weights = [("w", w)]
        if k * k * cin > _CENTERED_K:
            weights.append(("winsum", torch.ones(
                (1 if shared else samples, cin, k, k), device=dev)))
        for what, wt in weights:
            t0 = time.perf_counter()
            got = conv_sum(x, wt, (stride, stride), k // 2, groups)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            check(bool((got == got.round()).all()),
                  f"{name} {what}: conv sums not integral")
            ref = F.conv2d(x.double().permute(0, 3, 1, 2).contiguous(),
                           wt.double(), stride=stride, padding=k // 2,
                           groups=groups).permute(0, 2, 3, 1)
            err = float((got - ref).abs().max())
            print(f"conv {name} {what}: K={k * k * cin} {str(got.dtype)[6:]}"
                  f" out {tuple(got.shape)} max|port - f64 NCHW| {err} "
                  f"({ms:.1f} ms, first call)")
            check(err == 0, f"conv {name} {what} differs from float64")
            _spot_check(x, wt, stride, k // 2, groups, got, seed=seed)
            del got, ref
        del x, w
    # the dense head: (S, B, 192) x (S, 192, 10), float32 batched product
    x = torch.randint(-127, 128, (samples, batch, 192), generator=g,
                      device=dev).float()
    w = torch.randint(-128, 128, (samples, 192, 10), generator=g,
                      device=dev).float()
    with no_tf32():
        got = torch.bmm(x, w)
    err = float((got.double() - torch.bmm(x.double(), w.double())).abs()
                .max())
    print(f"dense fc: K=192 float32 max|port - f64| {err}")
    check(err == 0, "dense product differs from float64")


def _same_codes(a, b, what):
    check(a.codes.shape == b.codes.shape, f"{what}: shapes")
    diff = int((a.codes.to(torch.int32) - b.codes.to(torch.int32)).abs()
               .max())
    check(diff == 0, f"{what}: int8 codes differ by {diff}")


def phase_main(seed, state, model, plan, dev):
    """`evaluate` on BATCHES batches, then the kernel path against the
    plain-draw path and the card against the CPU; returns the draw
    kernel's launches during `evaluate`."""
    rng = np.random.default_rng(seed)
    data = [(rng.random((BATCH, 32, 32, 3), dtype=np.float32),
             rng.integers(0, 10, BATCH)) for _ in range(BATCHES)]
    seen = []

    def batches():
        for x, y in data:
            seen.append(sw.launches)
            yield x, y

    gen = torch.Generator().manual_seed(seed)
    sw.launches = 0
    metric_state, probs, seconds = evaluate(model, state, batches(),
                                            SAMPLES, gen, dev)
    launches = sw.launches
    check(seen == list(range(BATCHES)), f"launches before each batch {seen}")
    check(launches == BATCHES, f"launches {launches}")
    es = BATCH * SAMPLES
    for i, (p, dt) in enumerate(zip(probs, seconds)):
        check(p.shape == (BATCH, 10), f"probs shape {tuple(p.shape)}")
        check(bool(torch.isfinite(p).all()), "non-finite probabilities")
        err = float((p.sum(-1) - 1).abs().max())
        check(err < 1e-5, f"probabilities sum to 1 within {err}")
        print(f"batch {i}: {1e3 * dt:.1f} ms, {es / dt:.0f} "
              f"example-samples/s, draw launches so far {seen[i] + 1}")
    metrics = {k: float(v) for k, v in cls_metrics_compute(
        metric_state).items()}
    print("metric state:", json.dumps(
        {k: v.tolist() for k, v in metric_state.items()}))
    print("metrics:", json.dumps(metrics))
    steady = seconds[1:] or seconds
    print(f"main path: {BATCHES} batches of B={BATCH} x "
          f"S={SAMPLES}, steady {1e3 * sum(steady) / len(steady):.1f} "
          f"ms/batch, {es * len(steady) / sum(steady):.0f} "
          f"example-samples/s")

    # the same batch with the same explicit noise through the kernel path
    # and the plain-draw path: identical codes at every cut
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    layers = plan_layers(state, plan)
    noise = [torch.randn((SAMPLES,) + tuple(w.shape), generator=g,
                         device=dev) for (w, *_r) in layers]
    x = torch.as_tensor(data[0][0], device=dev)
    with torch.no_grad():
        k_tree = draw_sampled_weights(state, plan, SAMPLES, noise=noise)
        p_tree = sampled_tree(plan, plain_draw(layers, noise))
        for cut in CUTS + (None,):
            a = mc_predict(model, state, x, samples=SAMPLES,
                           presampled=k_tree, up_to=cut)
            b = mc_predict(model, state, x, samples=SAMPLES,
                           presampled=p_tree, up_to=cut)
            if cut is None:
                d = float((a - b).abs().max())
                check(d == 0.0, f"probabilities differ by {d}")
            else:
                _same_codes(a, b, f"cut {cut}")
            print(f"kernel path == plain path at cut {cut or 'probs'}")

        # the card against the CPU path (held against qbn_tpu by the
        # CPU tests) on a small input: B=4, S=4
        s_small = 4
        cpu = torch.device("cpu")
        state_cpu = to_device(state, cpu)
        noise_s = [torch.randn((s_small,) + tuple(w.shape), generator=g,
                               device=dev) for (w, *_r) in layers]
        t_gpu = draw_sampled_weights(state, plan, s_small, noise=noise_s)
        t_cpu = draw_sampled_weights(state_cpu, plan, s_small,
                                     noise=[n.cpu() for n in noise_s])
        xs = x[:4]
        for cut in CUTS + (None,):
            a = mc_predict(model, state, xs, samples=s_small,
                           presampled=t_gpu, up_to=cut)
            b = mc_predict(model, state_cpu, xs.cpu(), samples=s_small,
                           presampled=t_cpu, up_to=cut)
            if cut is None:
                d = float((a.cpu() - b).abs().max())
                print(f"card vs CPU probabilities max diff {d:.3g}")
                check(d <= 1e-6, "card and CPU probabilities differ")
            else:
                a.codes = a.codes.cpu()
                _same_codes(a, b, f"card vs CPU at {cut}")
        print("card == CPU path (small input) at every cut")
    return launches


def phase_profile(model, state, seed, dev):
    """One batch of the main path under torch.profiler: device time by
    kernel, and the device's idle share of the batch's wall time."""
    rng = np.random.default_rng(seed + 1)
    batch = [(rng.random((BATCH, 32, 32, 3), dtype=np.float32),
              rng.integers(0, 10, BATCH))]
    gen = torch.Generator().manual_seed(seed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _state, _probs, secs = evaluate(model, state, batch, SAMPLES, gen,
                                        dev)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]       # kernels, not ops
    busy_us = sum(e.self_device_time_total for e in rows)
    wall_us = 1e6 * secs[0]
    if busy_us == 0:
        print("profiled batch: the profiler saw no device time (not "
              "measured)")
        return
    # one stream: busy time above the wall clock means the profiler's
    # kernel times cannot be trusted for an idle share
    idle = (f"{1 - busy_us / wall_us:.3f}" if busy_us <= wall_us else
            "not measured (profiled device time exceeds the wall clock)")
    print(f"profiled batch: wall {wall_us / 1e3:.1f} ms (profiler on), "
          f"device busy {busy_us / 1e3:.1f} ms, idle share {idle}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<5d} {e.key[:100]}")


def phase_times(state, plan, samples, seed):
    """The draw kernel and its plain version at the flagship shapes, in
    turns, and the kernel's bound; returns (ms, plain_ms, bound_ms,
    bound_by)."""
    dev = torch.device("cuda")
    layers = plan_layers(state, plan)
    pack = sw.pack_layers(layers, samples)
    gen = torch.Generator().manual_seed(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(samples,) + tuple(w.shape) for (w, *_r) in layers]

    def plain():
        plain_draw(layers, [torch.randn(s, generator=g, device=dev)
                            for s in shapes])

    def kernel():
        sw.draw_layers(pack, generator=gen)

    codes = samples * sum(w.numel() for (w, *_r) in layers)
    in_bytes = 2 * pack.w.numel() + 4 * pack.qtab.numel() \
        + 8 * pack.meta.numel()
    bytes_ms = 1e3 * (codes + in_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * codes * OPS_PER_CODE / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    # turns: plain, kernel, kernel, plain
    t = [cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)]
    plain_ms, ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"draw S={samples}, {len(layers)} layers, {codes} codes: kernel "
          f"{t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} ms, ops "
          f"{ops_ms:.4f} ms)")
    return ms, plain_ms, bound_ms, bound_by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    with Phase("device"):
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        print(f"nvidia-smi: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {kind} "
              f"count {torch.cuda.device_count()}")
    with Phase("build"):
        t0 = time.perf_counter()
        lib = _build.build("sample_weights", force=True)
        print(f"nvcc {' '.join(_build.NVCC_FLAGS)} -> {os.path.relpath(lib, ROOT)}"
              f" in {time.perf_counter() - t0:.2f} s")
        print(_build.BUILD_LOGS["sample_weights"].strip())
    with Phase("load"):
        cfg, model, state = load_trained(EXP, device="cuda")
        plan = presample_plan(state)
        check(len(plan) == 21, f"{len(plan)} stochastic layers")
    with Phase("kernel"):
        max_err = phase_kernel(state, plan, SAMPLES, args.seed, dev)
    with Phase("conv"):
        phase_conv(BATCH, SAMPLES, args.seed, dev)
        torch.cuda.empty_cache()
    with Phase("main"):
        launches = phase_main(args.seed, state, model, plan, dev)
        torch.cuda.empty_cache()
    with Phase("profile"):
        phase_profile(model, state, args.seed, dev)
    with Phase("times"):
        ms, plain_ms, bound_ms, bound_by = phase_times(
            state, plan, SAMPLES, args.seed)
    print(f"total seconds {time.perf_counter() - t_start:.1f}")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{
        "name": "sample_weights", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
