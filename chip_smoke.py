#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``h2o3_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--rows 2000000] [--out result.json]

Run from the root of a checkout. Phases, each of which must pass:

1. a CUDA card is present (else exit 2); print its name and power limit;
2. build the histogram kernel from ``h2o3_tpu_torch/csrc`` with nvcc;
3. hold the kernel against its plain PyTorch version on the card at the
   shapes the fits give it (N rows x 28 features, 257 and 21 bins, 1 to 64
   nodes, 11 features, 30% inactive rows with one empty node, with and
   without a count weight): rtol 1e-5 / atol 1e-4 on Σg/Σh, counts exact,
   empty node exactly zero, two calls bit-identical and so the build for
   the padded node count; time the kernel, the plain version and one
   ``index_add_`` call;
4. train XGBoost (10 trees, defaults: depth 6, 256 bins) on a HIGGS-shaped
   frame (N x 28 numeric, binary response), predict, score; check that the
   kernel ran once per level built, that AUC is finite and above 0.5, that
   the same fit with the plain histogram on the card gives the same trees
   (or AUC within 1e-4), and that a small fit on the card gives the same
   trees as on the CPU;
5. the same for GBM (10 trees, defaults: depth 5, 20 bins);
6. with ``--profile``, one more XGBoost fit under ``torch.profiler``: device
   time by kernel, and the device's idle share of the fit.

It prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then as the last line ``{"ok": true, "device": {...}}``. Any failure
exits nonzero before those lines. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-5, 1e-4
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, op/s
FP32_OPS_PER_S = 67e12


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def synth_higgs(n_rows: int, n_feat: int, seed: int):
    """HIGGS-shaped binary data: N(0,1) features, a logistic response."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    w = rng.normal(size=n_feat) / np.sqrt(n_feat)
    logit = X @ w + 0.5 * X[:, 0] * X[:, 1]
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return X, y


def make_frame(X, y):
    from h2o3_tpu_torch import ColType, Column, Frame

    cols = [Column(f"x{j}", X[:, j], ColType.NUM) for j in range(X.shape[1])]
    cols.append(Column("y", y, ColType.CAT, ["0", "1"]))
    return Frame(cols)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(n, n_feat, n_bins1, k, weighted, seed, dev):
    """One kernel-vs-plain check on k nodes; returns its record."""
    import torch

    from h2o3_tpu_torch.ops import cuda_histogram as ch
    from h2o3_tpu_torch.ops.histogram import pad_nodes

    gen = torch.Generator(device=dev).manual_seed(seed)
    bins_fm = torch.randint(0, n_bins1, (n_feat, n), generator=gen,
                            device=dev, dtype=torch.int32)
    nodes = torch.randint(0, k, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    empty = k // 2 if k >= 3 else None
    if empty is not None:
        nodes[nodes == empty] = empty + 1
    nodes[torch.rand(n, generator=gen, device=dev) < 0.3] = -1
    g = torch.rand(n, generator=gen, device=dev) * 2 - 1
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    rw = (torch.randint(1, 4, (n,), generator=gen, device=dev).float()
          if weighted else None)

    a = ch.hist_nodematmul(bins_fm, nodes, g, h, k, n_bins1, rw=rw)
    b = ch.hist_nodematmul(bins_fm, nodes, g, h, k, n_bins1, rw=rw)
    ref = ch.hist_nodematmul_reference(bins_fm, nodes, g, h, k, n_bins1, rw=rw)
    torch.cuda.synchronize()
    name = f"N={n} F={n_feat} B1={n_bins1} K={k}{' rw' if weighted else ''}"
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two kernel calls differ")
    k_pad = pad_nodes(k)
    if not torch.equal(ch.hist_nodematmul(bins_fm, nodes, g, h, k_pad, n_bins1, rw=rw)[:k], a):
        raise AssertionError(f"{name}: the build for {k_pad} padded nodes differs")
    if not torch.equal(a[..., 2], ref[..., 2]):
        raise AssertionError(f"{name}: counts differ from the plain version")
    if empty is not None and not torch.all(a[empty] == 0):
        raise AssertionError(f"{name}: empty node {empty} is not exactly zero")
    if not torch.allclose(a, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError(
            f"{name}: max |kernel - plain| {(a - ref).abs().max().item()} "
            f"outside rtol {RTOL} / atol {ATOL}")
    max_err = (a - ref).abs().max().item()

    ms = time_ms(lambda: ch.hist_nodematmul(bins_fm, nodes, g, h, k, n_bins1, rw=rw),
                 reps=10)
    plain_ms = time_ms(
        lambda: ch.hist_nodematmul_reference(bins_fm, nodes, g, h, k, n_bins1, rw=rw),
        reps=3)
    # the one PyTorch call computing the same function: index_add_ of the
    # [N*F, 3] masked (g, h, w) rows at the flat (node, feature, bin) index
    valid = nodes >= 0
    node0 = torch.where(valid, nodes, 0).long()
    flat = ((node0[None, :] * n_feat + torch.arange(n_feat, device=dev)[:, None])
            * n_bins1 + bins_fm.long()).reshape(-1)
    wv = valid.float()
    cw = wv if rw is None else wv * rw
    src = torch.stack([g * wv, h * wv, cw], dim=1)[None].expand(n_feat, n, 3) \
        .reshape(-1, 3)
    lib_out = torch.zeros(k * n_feat * n_bins1, 3, device=dev)
    library_ms = time_ms(lambda: lib_out.zero_().index_add_(0, flat, src), reps=3)
    del flat, src, lib_out

    n_active = int(valid.sum().item())
    in_bytes = 4 * n + n_active * (4 * n_feat + 8 + (4 if weighted else 0))
    out_bytes = 4 * k * n_feat * n_bins1 * 3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n_active * n_feat / FP32_OPS_PER_S * 1e3
    rec = {
        "case": name, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print(f"kernel check ok: {json.dumps(rec)}", flush=True)
    return rec


def trees_equal(ma, mb) -> bool:
    for ta, tb in zip(ma.booster.trees_per_class, mb.booster.trees_per_class):
        for f in ("feat", "split_bin", "default_left", "is_split"):
            if not np.array_equal(np.stack(getattr(ta, f)), np.stack(getattr(tb, f))):
                return False
    return True


def run_fit(builder_cls, frame, n_rows, expect_launches, label, small_frame, **kw):
    """Train + predict + score one builder on the card through the kernel,
    then check it against the plain histogram and against the CPU."""
    import torch

    from h2o3_tpu_torch import use_device
    from h2o3_tpu_torch.ops import cuda_histogram as ch

    ch.reset_launch_counts()
    t0 = time.time()
    model = builder_cls(response_column="y", **kw).train(frame)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    t0 = time.time()
    pred = model.predict(frame)
    predict_s = time.time() - t0
    t0 = time.time()
    perf = model.model_performance(frame)
    perf_s = time.time() - t0
    launches = ch.LAUNCHES["hist_nodematmul"]
    if launches != expect_launches:
        raise AssertionError(
            f"{label}: hist_nodematmul launched {launches} times on the main "
            f"path, expected {expect_launches} (one per level built)")
    p1 = pred.col("p1").data
    if p1.shape != (n_rows,) or not np.all(np.isfinite(p1)):
        raise AssertionError(f"{label}: predictions are not {n_rows} finite values")
    auc = perf.auc
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"{label}: AUC {auc} is not finite and above 0.5")

    plain = builder_cls(response_column="y", hist_impl="plain", **kw).train(frame)
    same_plain = trees_equal(model, plain)
    plain_auc = plain.training_metrics.auc
    if not same_plain and abs(plain_auc - auc) > 1e-4:
        raise AssertionError(
            f"{label}: plain-histogram fit differs (AUC {plain_auc} vs {auc})")

    card = builder_cls(response_column="y", **kw).train(small_frame)
    card_plain = builder_cls(response_column="y", hist_impl="plain",
                             **kw).train(small_frame)
    with use_device("cpu"):
        cpu = builder_cls(response_column="y", tree_subtract=True,
                          **kw).train(small_frame)
    same_cpu = trees_equal(card, cpu)
    if not same_cpu and abs(card.training_metrics.auc - cpu.training_metrics.auc) > 1e-4:
        raise AssertionError(f"{label}: small fit on the card differs from the CPU")

    rec = {
        "fit": label, "rows": n_rows, "train_s": train_s,
        "train_rows_per_s": n_rows / train_s, "predict_s": predict_s,
        "predict_rows_per_s": n_rows / predict_s, "model_performance_s": perf_s,
        "auc": auc, "logloss": perf.logloss, "hist_launches": launches,
        "prep_s": model.timings["prep_s"], "boost_s": model.timings["train_s"],
        "plain_trees_equal": same_plain, "plain_auc": plain_auc,
        "small_card_vs_cpu_trees_equal": same_cpu,
        "small_card_vs_card_plain_trees_equal": trees_equal(card, card_plain),
        "small_auc_card_cpu": [card.training_metrics.auc, cpu.training_metrics.auc],
    }
    print(f"fit ok: {json.dumps(rec)}", flush=True)
    return rec


def profile_fit(builder_cls, frame, **kw):
    """Device time by kernel name over one more fit, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model = builder_cls(response_column="y", **kw).train(frame)
        torch.cuda.synchronize()
    wall_s = time.time() - t0
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    rec = {
        "fit_wall_s": wall_s, "prep_s": model.timings["prep_s"],
        "boost_s": model.timings["train_s"], "device_busy_ms": busy_ms,
        "device_idle_share_of_fit": 1 - busy_ms / 1e3 / wall_s,
        "top_device_ms": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                          for e in top],
    }
    print(f"profile: {json.dumps(rec)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more XGBoost fit (device time by kernel)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from h2o3_tpu_torch import GBM, XGBoost
    from h2o3_tpu_torch.ops import cuda_histogram as ch

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    t0 = time.time()
    ch.load_library()
    build_s = time.time() - t0
    print(f"kernel build: {build_s:.1f} s", flush=True)
    for line in ch.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    n, seed = args.rows, args.seed
    cases = [
        (n, 28, 257, 16, False),  # XGBoost's widest level built (subtraction)
        (n, 28, 257, 1, True),  # the root
        (n, 28, 257, 64, False),  # the widest level this kernel serves
        (n, 28, 21, 8, False),  # GBM's widest level built (subtraction)
        (n, 28, 21, 64, True),
        (n, 11, 257, 40, True),  # F not a multiple of 8
    ]
    checks = [kernel_case(*c, seed=seed + i, dev=dev) for i, c in enumerate(cases)]
    torch.cuda.empty_cache()

    X, y = synth_higgs(n, 28, seed)
    frame = make_frame(X, y)
    small_frame = make_frame(*synth_higgs(20_000, 28, seed + 1))
    fits = [
        run_fit(XGBoost, frame, n, args.trees * 6, "xgboost", small_frame,
                ntrees=args.trees, seed=seed),
        run_fit(GBM, frame, n, args.trees * 5, "gbm", small_frame,
                ntrees=args.trees, seed=seed),
    ]

    prof = (profile_fit(XGBoost, frame, ntrees=args.trees, seed=seed)
            if args.profile else None)

    main_case = checks[0]
    kernels = [{
        "name": "hist_nodematmul",
        "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/hist_nodematmul.cu",
        "replaces": "h2o3_tpu/ops/pallas_histogram.py:94",
        "launches": fits[0]["hist_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "device": kind, "torch": torch.__version__,
                       "build_s": build_s, "kernel_checks": checks,
                       "fits": fits, "profile": prof, "kernels": kernels},
                      fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
