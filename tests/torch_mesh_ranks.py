"""Rank bodies of the port's row-sharded CPU tests (not collected: the
name does not start with ``test_``).

``start_ranks(body, world, tmp_dir, *args)`` starts ``world`` processes
(``multiprocessing``'s spawn context). Each pins ``torch.set_num_threads(1)``,
joins a gloo process group over a ``FileStore`` under ``tmp_dir`` (no TCP
port to collide with another test worker) with a collective timeout of
``GROUP_TIMEOUT_S``, runs ``body(mesh, *args)`` and writes what it returns
to ``tmp_dir``; ``join_ranks`` waits at most ``JOIN_TIMEOUT_S`` for them,
kills what is left, and returns every rank's result in rank order or
raises with the failed ranks' tracebacks. The parent computes its own
references (the JAX package, the port without a group) while the ranks
run.

This module imports torch, numpy and the port, never JAX, so a spawned
rank never imports JAX either.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from typing import Callable, List

import numpy as np
import torch

JOIN_TIMEOUT_S = 120.0
GROUP_TIMEOUT_S = 60.0


class Ranks:
    def __init__(self, name: str, world: int, tmp_dir: str, procs: list):
        self.name, self.world, self.tmp_dir, self.procs = name, world, tmp_dir, procs


def start_ranks(body: Callable, world: int, tmp_dir: str, *args) -> Ranks:
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_dir), f"store_{body.__name__}_{world}")
    procs = [ctx.Process(target=_rank_main,
                         args=(body.__name__, r, world, store, str(tmp_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(body.__name__, world, str(tmp_dir), procs)


def join_ranks(ranks: Ranks) -> List:
    deadline = time.time() + JOIN_TIMEOUT_S
    for p in ranks.procs:
        p.join(max(0.0, deadline - time.time()))
    alive = [r for r, p in enumerate(ranks.procs) if p.is_alive()]
    for p in ranks.procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results, errors = [], []
    for r in range(ranks.world):
        path = _out_path(ranks.tmp_dir, ranks.name, ranks.world, r)
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {ranks.procs[r].exitcode})")
            continue
        with open(path, "rb") as fh:  # written by this module's own ranks
            out = pickle.load(fh)
        if "error" in out:
            errors.append(f"rank {r}:\n{out['error']}")
        else:
            results.append(out["ok"])
    if alive:
        errors.append(f"ranks {alive} still running after {JOIN_TIMEOUT_S} s")
    if errors:
        raise AssertionError(f"{ranks.name} at world size {ranks.world}:\n" +
                             "\n".join(errors))
    return results


def _out_path(tmp_dir: str, name: str, world: int, rank: int) -> str:
    return os.path.join(tmp_dir, f"{name}_{world}_{rank}.pkl")


def _rank_main(name: str, rank: int, world: int, store: str, tmp_dir: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    from h2o3_tpu_torch.parallel import mesh as pm

    try:
        pm.distributed_initialize(backend="gloo", init_method=f"file://{store}",
                                  rank=rank, world_size=world, device="cpu",
                                  timeout=GROUP_TIMEOUT_S)
        out = {"ok": globals()[name](pm.default_mesh(), *args)}
    except BaseException:  # reported to the parent, which raises
        out = {"error": traceback.format_exc()}
    finally:
        pm.destroy()
    with open(_out_path(tmp_dir, name, world, rank), "wb") as fh:
        pickle.dump(out, fh)


# ---------------------------------------------------------------------------
# helpers shared by the bodies and the tests


def trees_of(booster) -> dict:
    """A booster's tree arrays per class, stacked per field."""
    out = {}
    for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
        out[f] = [np.stack(getattr(t, f)) for t in booster.trees_per_class]
    return out


def fit_boosted(case: dict, mesh=None):
    """``train_boosted`` of one case (its data and arguments), on the CPU."""
    from h2o3_tpu_torch.models.tree.booster import TreeParams, train_boosted

    kw = dict(case["kw"])
    params = TreeParams(**kw.pop("params"))
    return train_boosted(case["X"], case["objective"], case["y"], case["n_class_trees"],
                         case["init_margin"], params, device="cpu", mesh=mesh, **kw)


def root_histogram(case: dict, mesh=None) -> np.ndarray:
    """The root histogram of a case's first round (g, h at its initial
    margin, every row active), merged over ``mesh``."""
    from h2o3_tpu_torch.models.tree.booster import grad_hess_device
    from h2o3_tpu_torch.ops.histogram import build_histogram_sharded, make_bins
    from h2o3_tpu_torch.parallel.mesh import default_mesh, local_rows, row_mask
    from h2o3_tpu_torch.models.tree import booster

    mesh = mesh or default_mesh()
    X, y = case["X"], np.asarray(case["y"], np.float32)
    nbins = case["kw"]["params"]["nbins"]
    edges = make_bins(X, nbins, seed=case["kw"]["params"]["seed"])
    codes = booster._local_codes(X, edges, torch.device("cpu"), mesh)
    s = mesh.rows(len(X))[2]
    yl = torch.from_numpy(np.ascontiguousarray(local_rows(y, mesh)))
    m0 = torch.full((s, 1), float(case["init_margin"][0]))
    g, h = grad_hess_device(case["objective"], yl, m0)
    nodes = torch.where(row_mask(len(X), s * mesh.size, mesh, "cpu"), 0, -1).int()
    return build_histogram_sharded(codes, nodes, g[:, 0].contiguous(), h[:, 0].contiguous(),
                                   1, nbins + 1, mesh, impl="plain").numpy()


def early_stopping_gbm(d: dict, kw: dict):
    """The early-stopping GBM of ``test_early_stopping_matches_jax`` through
    the builder, on the CPU: (trees built, tree arrays, scores, predictions)."""
    import h2o3_tpu_torch as ht

    with ht.use_device("cpu"):
        fr = ht.Frame.from_dict(d)
        model = ht.GBM(tree_subtract=False, **kw).train(fr)
        pred = model.booster.predict_margin(
            np.stack([d[f"x{j}"] for j in range(4)], axis=1))
    scores = [h["score"] for h in model.scoring_history]
    return model.ntrees_built, trees_of(model.booster), scores, pred


def grid_under_skewed_clock(mesh, d: dict, kw: dict) -> int:
    """A 3-cell GBM grid under a wall-clock budget, where the last rank's
    clock jumps past the budget after the first cell: every rank stops
    after that cell, since the stop is taken where any rank takes it.
    Returns the cells this rank built."""
    import h2o3_tpu_torch as ht
    from h2o3_tpu_torch.models import grid as grid_mod

    real, calls = time.time, [0]

    class Clock:  # the grid reads the clock for its start, then before each cell
        @staticmethod
        def time():
            calls[0] += 1
            late = mesh.rank == mesh.size - 1 and calls[0] >= 3
            return real() + (1e9 if late else 0.0)

    grid_mod.time = Clock
    try:
        with ht.use_device("cpu"):
            base = ht.GBM(**{**kw, "ntrees": 2, "stopping_rounds": 0}).params
            g = ht.GridSearch(ht.GBM, base, {"max_depth": [2, 3, 4]},
                              search_criteria=grid_mod.SearchCriteria(max_runtime_secs=1e6)
                              ).train(ht.Frame.from_dict(d))
    finally:
        grid_mod.time = time
    return len(g.models)


def deeplearning_under_skewed_clock(mesh, d: dict, kw: dict) -> int:
    """A 4-epoch DeepLearning fit (whole on every rank) under a wall-clock
    budget, where the last rank's clock jumps past it after the first
    epoch: every rank stops after that epoch. Returns this rank's epochs."""
    import h2o3_tpu_torch as ht
    from h2o3_tpu_torch.models import deeplearning as dl_mod

    real, calls = time.time, [0]

    class Clock:  # the fit reads the clock for its deadline, then 3 times an epoch
        @staticmethod
        def time():
            calls[0] += 1
            late = mesh.rank == mesh.size - 1 and calls[0] >= 3
            return real() + (1e9 if late else 0.0)

    dl_mod.time = Clock
    try:
        with ht.use_device("cpu"):
            model = ht.DeepLearning(
                response_column=kw["response_column"], ignored_columns=kw["ignored_columns"],
                hidden=[4], epochs=4, mini_batch_size=64, seed=0, max_runtime_secs=1e6,
            ).train(ht.Frame.from_dict(d))
    finally:
        dl_mod.time = time
    return model.epochs_trained


# ---------------------------------------------------------------------------
# rank bodies


def boost_body(mesh, cases: dict, gbm: tuple):
    """The sharded booster cases, the early-stopping GBM, the merged root
    histogram, a grid and a DeepLearning fit whose budgets run out on one
    rank's clock only, a
    repeat ``distributed_initialize`` (benign), and a collective that one
    rank never joins (it raises at the timeout)."""
    from h2o3_tpu_torch.parallel import mesh as pm

    out = {"rank": mesh.rank, "size": mesh.size}
    for name, case in cases.items():
        b = fit_boosted(case)
        out[name] = (trees_of(b), b.predict_margin(case["X"]))
    out["root_hist"] = root_histogram(next(iter(cases.values())))
    out["gbm"] = early_stopping_gbm(*gbm)
    out["grid_cells"] = grid_under_skewed_clock(mesh, *gbm)
    out["dl_epochs"] = deeplearning_under_skewed_clock(mesh, *gbm)
    out["collectives"] = pm.COUNTS["collectives"]
    # a repeat initialization is benign, whatever it is given
    pm.distributed_initialize(backend="gloo", rank=99, world_size=1)
    # a collective that one rank never joins raises at its group's timeout
    import datetime

    import torch.distributed as dist

    short = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=2))
    m = pm.Mesh(short, mesh.rank, mesh.size, "gloo", torch.device("cpu"))
    if mesh.rank == 0:
        t0 = time.time()
        try:
            pm.psum(torch.ones(3), m)
            out["timeout"] = None
        except RuntimeError as e:
            out["timeout"] = (time.time() - t0, str(e)[:200])
    else:
        time.sleep(4.0)
    return out


def init_failures(store_dir: str) -> List[str]:
    """The messages of ``distributed_initialize`` with wrong arguments (in a
    process with no group)."""
    from h2o3_tpu_torch.parallel import mesh as pm

    msgs = []
    for kw in (dict(backend="gloo", init_method=f"file://{store_dir}/bad_rank",
                    rank=5, world_size=2, timeout=5),
               dict(backend="gloo", init_method=f"file://{store_dir}/no_size", rank=0),
               dict(backend="gloo", rank=0, world_size=1, color="blue")):
        try:
            pm.distributed_initialize(**kw)
            msgs.append("no error")
        except (RuntimeError, ValueError, TypeError) as e:
            msgs.append(f"{type(e).__name__}: {e}")
    return msgs


def compute_body(mesh, d: dict, keys: dict, codes: np.ndarray, vals: np.ndarray,
                 n_groups: int, Xi: np.ndarray, wz: np.ndarray, w: np.ndarray,
                 glm_frame: dict, glm_kw: dict):
    """``map_reduce``, ``map_batches``, the sample sort, ``searchsorted``,
    the group aggregation, the GLM Gram, a sharded IRLSM fit, and the
    mesh's own helpers (``DATA_AXIS``, ``device_count``, ``row_sharding``,
    ``shard_table``, ``any_rank``)."""
    import h2o3_tpu_torch as ht
    from h2o3_tpu_torch.compute import mapreduce as mr
    from h2o3_tpu_torch.models.glm import _gram
    from h2o3_tpu_torch.parallel import mesh as pm
    from h2o3_tpu_torch.rapids import dist

    out = {}
    fr = ht.Frame.from_dict(d)
    t = mr.FrameTable.from_frame(fr, device="cpu")
    out["table"] = (t.n_valid, t.n_padded, int(t.mask.sum()))
    out["sum"] = mr.map_reduce(
        lambda c, m: {"n": (m & ~torch.isnan(c["x"])).sum(),
                      "sum": torch.where(m & ~torch.isnan(c["x"]), c["x"], 0.0).sum()}, t)
    out["max"] = mr.map_reduce(
        lambda c, m: torch.max(torch.where(m, c["y"], -np.inf)), t, reduce="max")
    out["min"] = mr.map_reduce(
        lambda c, m: torch.min(torch.where(m, c["y"], np.inf)), t, reduce="min")
    out["batches"] = mr.gather_rows(
        mr.map_batches(lambda c, m: c["x"] * 2.0 + c["y"], t), t.n_valid)
    out["argsort"] = dist.device_argsort_u64(keys["u"], "cpu")
    out["lexsort"] = dist.device_lexsort(keys["lex"], "cpu")
    table = np.sort(keys["u"])
    out["search"] = (dist.device_searchsorted(table, keys["u"], "left", "cpu"),
                     dist.device_searchsorted(table, keys["u"], "right", "cpu"),
                     dist.device_searchsorted_both(table, keys["u"], "cpu"))
    out["groups"] = dist.device_group_aggregate(codes, vals, n_groups, "cpu")
    Xd, n = pm.shard_rows(Xi, mesh, device="cpu")
    out["gram"] = _gram(Xd, pm.local_rows(wz, mesh), pm.local_rows(w, mesh), mesh)
    with ht.use_device("cpu"):
        model = ht.GLM(**glm_kw).train(ht.Frame.from_dict(glm_frame))
    out["glm"] = (model.iterations, dict(model.coefficients))
    cols, mask, n_tab = pm.shard_table({"x": d["x"], "y": d["y"]}, mesh, device="cpu")
    out["mesh_api"] = (pm.DATA_AXIS, pm.device_count(), pm.row_sharding(mesh, n),
                       {k: v.numpy() for k, v in cols.items()}, mask.numpy(), n_tab,
                       pm.any_rank(mesh.rank == mesh.size - 1, mesh),
                       pm.any_rank(False, mesh))
    out["collectives"] = pm.COUNTS["collectives"]
    return out
