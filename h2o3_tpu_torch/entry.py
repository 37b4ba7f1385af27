"""Entry points of the port — the counterparts of the repository's
``__graft_entry__.entry`` and ``dryrun_multichip``.

``entry(device=None)`` -> ``(fn, args)``: ``fn(*args)`` sums 4 random
trees of depth 4 over 256 rows x 8 features of 17-bin codes
(``models/tree/booster._predict_stacked``), the inputs drawn from
``np.random.default_rng(0)`` exactly as the JAX entry draws them and placed
on the resolved device (``device.resolve_device``: ``cuda`` unless asked
for the CPU). The JAX entry's codes are row-major ``[N, F]``; the port's
walk reads feature-major ``[F, N]`` codes and takes the bin count as a
Python int.

``dryrun_multichip(n_devices, device=None)`` starts ``n_devices`` ranks
(spawned processes) in one process group, NCCL with one rank per card on
``cuda`` (the default) or gloo on ``cpu``, and runs in them the four checks
of ``__graft_entry__.py:41-186``: one sharded boosting round; the
histogram-subtraction level flow on and off, giving equal margins; the
sample sort, the sharded ``searchsorted`` and the group-by; and the
sharded GLM Gram against a float64 host product. It raises if a rank
fails or the ranks do not finish in ``DRYRUN_TIMEOUT_S``. On ``cuda`` with fewer
cards than ``n_devices`` it raises: there is no CPU fallback.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import traceback

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.models.tree.booster import _predict_stacked


def entry(device: DeviceLike = None):
    dev = resolve_device(device)
    T, depth = 4, 4
    M = 2 ** (depth + 1) - 1
    nbins1 = 17
    rng = np.random.default_rng(0)
    bins = rng.integers(0, nbins1, size=(256, 8)).astype(np.int32)
    feat = rng.integers(0, 8, size=(T, M)).astype(np.int32)
    split_bin = rng.integers(0, nbins1 - 1, size=(T, M)).astype(np.int32)
    default_left = rng.random((T, M)) < 0.5
    is_split = rng.random((T, M)) < 0.5
    leaf = rng.normal(size=(T, M)).astype(np.float32)

    def fn(b, f, sb, dl, sp, lf, nb1):
        return _predict_stacked(b, f, sb, dl, sp, lf, depth, nb1)

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        bins.T, feat, split_bin, default_left, is_split, leaf)) + (nbins1,)
    return fn, args


#: seconds the dry run's ranks may take, and its group's collective timeout
DRYRUN_TIMEOUT_S = 600.0


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Run one sharded boosting round (and the sort, group-by and Gram
    checks) on ``n_devices`` ranks; see the module docstring."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        resolve_device(dev)  # raises without a card
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                               f"CUDA devices, {have} available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    work = tempfile.mkdtemp(prefix="h2o3_dryrun_")
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n_devices, dev.type, work))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DRYRUN_TIMEOUT_S)
        errors = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
                errors.append(f"rank {r}: did not finish in {DRYRUN_TIMEOUT_S} s")
            elif p.exitcode != 0:
                path = os.path.join(work, f"rank{r}.err")
                msg = open(path).read() if os.path.exists(path) else ""
                errors.append(f"rank {r}: exit code {p.exitcode}\n{msg}")
        if errors:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on {dev.type} failed:\n"
                               + "\n".join(errors))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _dryrun_rank(rank: int, world: int, dev_type: str, work: str) -> None:
    """One rank of ``dryrun_multichip``: join the group, run the checks,
    leave the group; a failure's traceback goes to ``work/rank<r>.err``."""
    from h2o3_tpu_torch.parallel import mesh as pm

    try:
        pm.distributed_initialize(
            backend="nccl" if dev_type == "cuda" else "gloo",
            init_method="file://" + os.path.join(work, "store"), rank=rank,
            world_size=world, device=f"cuda:{rank}" if dev_type == "cuda" else "cpu",
            timeout=DRYRUN_TIMEOUT_S)
        _dryrun_checks(pm.default_mesh())
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        pm.destroy()


def _dryrun_checks(mesh) -> None:
    """The JAX dry run's four checks (``__graft_entry__.py:125-186``) on
    ``mesh``, on every rank."""
    from h2o3_tpu_torch.models.glm import _gram
    from h2o3_tpu_torch.models.tree.booster import TreeParams, train_boosted
    from h2o3_tpu_torch.models.tree.common import init_margin
    from h2o3_tpu_torch.parallel.mesh import local_rows, shard_rows
    from h2o3_tpu_torch.rapids import dist

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    n_devices = mesh.size
    rng = np.random.default_rng(0)
    n = n_devices * 16 + 3  # not a multiple of the world size: pad rows
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) * 0.2 > 0).astype(np.float64)

    params = TreeParams(ntrees=1, max_depth=3, nbins=8, min_rows=1.0, seed=0)
    margins = {}
    for subtract in (False, True):
        booster = train_boosted(X, objective="bernoulli", y=y, n_class_trees=1,
                                init_margin=init_margin("bernoulli", y, 1),
                                params=params, subtract=subtract, mesh=mesh)
        margins[subtract] = booster.predict_margin(X)
        if margins[subtract].shape != (n, 1) or not np.isfinite(margins[subtract]).all():
            raise AssertionError(f"margin of shape {margins[subtract].shape}, not finite")
    say(f"dryrun_multichip({n_devices}): one boosting round OK on {mesh.backend} "
        f"({mesh.device})")
    if not np.allclose(margins[False], margins[True], rtol=1e-4, atol=1e-4):
        raise AssertionError("subtraction on and off give different margins")
    say(f"dryrun_multichip({n_devices}): subtraction level flow OK")

    keys = rng.normal(size=n)
    u = dist.encode_f64(keys)
    order = dist.device_argsort_u64(u)
    if not (np.diff(keys[order]) >= 0).all():
        raise AssertionError("sample sort out of order")
    table = np.sort(u)
    if not (dist.device_searchsorted(table, u, "left")
            == np.searchsorted(table, u, "left")).all():
        raise AssertionError("sharded searchsorted differs from numpy's")
    codes = rng.integers(0, 4, size=n).astype(np.int32)
    agg = dist.device_group_aggregate(codes, keys, 4)
    if int(agg["count"].sum()) != n:
        raise AssertionError(f"group counts sum to {agg['count'].sum()}, not {n}")
    say(f"dryrun_multichip({n_devices}): distributed sort/merge/groupby OK")

    Xi = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
    Xd, _ = shard_rows(Xi, mesh)
    w = np.ones(n, np.float64)
    wz = y - 0.5
    G, q = _gram(Xd, local_rows(wz, mesh), local_rows(w, mesh), mesh)
    want_G = Xi.astype(np.float64).T @ Xi.astype(np.float64)
    want_q = Xi.astype(np.float64).T @ wz
    if not (np.allclose(G, want_G, rtol=1e-4, atol=1e-3)
            and np.allclose(q, want_q, rtol=1e-4, atol=1e-3)):
        raise AssertionError("sharded GLM Gram differs from the float64 host product")
    say(f"dryrun_multichip({n_devices}): sharded GLM gram OK")
