"""Hyperparameter grid search — the port of ``h2o3_tpu/models/grid.py``.

Reference: ``hex/grid/GridSearch.java`` (the search loop), the walkers of
``hex/grid/HyperSpaceWalker.java:187-190,381`` — CartesianWalker (the full
product) and RandomDiscreteValueWalker (seeded sampling without
replacement under ``RandomDiscreteValueSearchCriteria``: max_models,
max_runtime_secs and ScoreKeeper-style early stopping over the sequence
of finished models) — and grid persistence (``hex/grid/Grid.java``).

Each cell is one model build on the device the search resolved when it
started (``device.resolve_device`` of the base parameters' ``device``);
every cell's parameters carry that device, so cells built on the worker
threads of ``parallelism > 1`` run where the caller asked, although
``use_device`` blocks are per thread. A failed cell is recorded in
``Grid.failures``, not raised (GridSearch.java's failed-params tracking).

Not part of this package yet: ``recovery_dir`` (auto-recovery snapshots,
which need ``recovery.py`` and ``frame/persist.py``; ROADMAP A11) and the
fan-out of cells across a cluster (``cluster/search.py``; ROADMAP A10).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models.framework import Model, ModelBuilder


def cell_key(hp: Dict[str, Any]) -> str:
    """Canonical identity of one grid cell: the sorted-JSON hyperparameter
    combo. Per-cell seeding keys on it."""
    return json.dumps(hp, sort_keys=True, default=str)


def cell_seed(search_seed: Optional[int], key: str) -> Optional[int]:
    """Per-cell builder seed derived from ``(search_seed, canonical cell
    key)``: independent of the cell's position in the walk, so reordering
    the walk or building cells in parallel never re-seeds a cell."""
    if search_seed is None or search_seed == -1:
        return None
    digest = hashlib.md5(f"{int(search_seed)}|{key}".encode()).digest()
    return int.from_bytes(digest[:8], "big") & 0x7FFFFFFF


@dataclass
class SearchCriteria:
    """hex/grid/HyperSpaceSearchCriteria.java."""

    strategy: str = "Cartesian"  # Cartesian | RandomDiscrete
    max_models: int = 0  # 0 = unlimited
    max_runtime_secs: float = 0.0  # 0 = unlimited
    seed: int = -1
    stopping_rounds: int = 0
    stopping_metric: str = "auto"
    stopping_tolerance: float = 1e-3


def _default_metric(model: Model) -> Tuple[str, bool]:
    """(metric name, larger_is_better) like ScoreKeeper.StoppingMetric auto."""
    if not model.is_classifier:
        return "rmse", False
    if model.nclasses == 2:
        return "auc", True
    return "logloss", False


def metric_value(model: Model, name: str = "auto") -> Tuple[float, bool]:
    """A metric from the CV metrics if present, else validation, else training."""
    mm = (
        model.cross_validation_metrics
        or model.validation_metrics
        or model.training_metrics
    )
    auto_name, larger = _default_metric(model)
    if name in (None, "", "auto"):
        name = auto_name
    else:
        larger = name.lower() in ("auc", "pr_auc", "gini", "r2", "accuracy", "f1")
    v = getattr(mm, name.lower(), np.nan)
    return float(v), larger


class Grid:
    """Search result container (hex/grid/Grid.java)."""

    def __init__(self, grid_id: Optional[str] = None) -> None:
        self.grid_id = grid_id or DKV.make_key("grid")
        self.models: List[Model] = []
        self.hyper_params: List[Dict[str, Any]] = []
        self.failures: List[Tuple[Dict[str, Any], str]] = []
        self.runtime_secs: float = 0.0
        DKV.put(self.grid_id, self)

    def get_grid(
        self, sort_by: str = "auto", decreasing: Optional[bool] = None
    ) -> "Grid":
        """A new Grid view with the models sorted by a metric."""
        if not self.models:
            return self
        vals = []
        for m in self.models:
            v, larger = metric_value(m, sort_by)
            vals.append(v)
        if decreasing is None:
            decreasing = larger
        order = np.argsort(vals)
        if decreasing:
            order = order[::-1]
        # NaNs always last
        order = sorted(order, key=lambda i: (np.isnan(vals[i]),))
        g = Grid.__new__(Grid)
        g.grid_id = self.grid_id
        g.models = [self.models[i] for i in order]
        g.hyper_params = [self.hyper_params[i] for i in order]
        g.failures = self.failures
        g.runtime_secs = self.runtime_secs
        return g

    @property
    def model_ids(self) -> List[str]:
        return [m.key for m in self.models]

    def summary_table(self, sort_by: str = "auto") -> List[Dict[str, Any]]:
        g = self.get_grid(sort_by)
        out = []
        for hp, m in zip(g.hyper_params, g.models):
            v, _ = metric_value(m, sort_by)
            out.append({**hp, "model_id": m.key, "metric": v})
        return out

    # -- persistence (export_grid / import_grid) ----------------------------
    def save(self, path: str) -> str:
        """Export on the allowlisted object-tree format of
        ``models/persist.py``, the container binary models use
        (hex/grid/Grid.java exportBinary)."""
        from h2o3_tpu_torch.models.persist import save_model

        return save_model(self, path)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "Grid":
        """Import a grid; its models land on ``device`` (resolved as every
        entry point resolves it)."""
        from h2o3_tpu_torch.models.persist import load_model

        # decode first, mutate the DKV only after the type check passes
        g = load_model(path, register=False, device=device)
        if not isinstance(g, Grid):
            raise ValueError(f"{path!r} is not a grid export")
        DKV.put(g.grid_id, g)
        for m in g.models:  # member models become addressable again too
            DKV.put(m.key, m)
        return g

    def __repr__(self) -> str:
        return (
            f"<Grid {self.grid_id}: {len(self.models)} models, "
            f"{len(self.failures)} failures>"
        )


def _cartesian(hyper: Dict[str, Sequence[Any]]):
    keys = sorted(hyper.keys())
    for combo in itertools.product(*(hyper[k] for k in keys)):
        yield dict(zip(keys, combo))


def _random_discrete(hyper: Dict[str, Sequence[Any]], seed: int):
    """Seeded sampling without replacement over the full product space
    (HyperSpaceWalker.java:381 RandomDiscreteValueWalker), by lazy
    rejection sampling: the product space is never materialized."""
    keys = sorted(hyper.keys())
    sizes = [len(hyper[k]) for k in keys]
    total = int(np.prod(sizes)) if sizes else 0
    rng = np.random.default_rng(None if seed in (-1, None) else seed)
    seen = set()
    while len(seen) < total:
        flat = int(rng.integers(total))
        if flat in seen:
            continue
        seen.add(flat)
        combo = {}
        for k, sz in zip(keys, sizes):
            combo[k] = hyper[k][int(flat % sz)]
            flat //= sz
        yield combo


class GridSearch:
    """Driver (hex/grid/GridSearch.java).

    ``builder_cls`` is a ModelBuilder subclass; ``params`` its base
    parameters object; ``hyper_params`` maps parameter names to candidate
    value lists."""

    def __init__(
        self,
        builder_cls: Type[ModelBuilder],
        params: Any,
        hyper_params: Dict[str, Sequence[Any]],
        search_criteria: Optional[SearchCriteria] = None,
        parallelism: int = 1,
        recovery_dir: Optional[str] = None,
    ) -> None:
        if recovery_dir:
            raise NotImplementedError(
                "GridSearch(recovery_dir=...) needs recovery.py and "
                "frame/persist.py, not ported yet (ROADMAP A11)")
        self.builder_cls = builder_cls
        self.params = params
        self.hyper_params = dict(hyper_params)
        self.criteria = search_criteria or SearchCriteria()
        self.parallelism = max(1, int(parallelism))
        self.device: Optional[torch.device] = None
        for k in self.hyper_params:
            if not hasattr(params, k):
                raise ValueError(f"unknown hyperparameter {k!r} for {builder_cls.__name__}")

    # -- determinism: canonical per-cell seeds -------------------------------
    def _search_seed(self) -> Optional[int]:
        """The seed the whole search derives per-cell seeds from: the
        search criteria's seed, else the base params' seed, else None."""
        if self.criteria.seed not in (-1, None):
            return int(self.criteria.seed)
        base = getattr(self.params, "seed", -1)
        if base not in (-1, None):
            return int(base)
        return None

    def _cell_params(self, hp: Dict[str, Any]):
        """Final builder params for one cell. When a seed is in play it
        derives from ``(search_seed, canonical cell key)``, not from the
        walk position. A seed in the hyper grid itself is honoured as is.
        Once the search has started, the cell runs on its device."""
        p = replace(self.params, **hp)
        if self.device is not None:
            p = replace(p, device=self.device)
        if "seed" in hp or not hasattr(p, "seed"):
            return p
        derived = cell_seed(self._search_seed(), cell_key(hp))
        if derived is None:
            return p
        return replace(p, seed=derived)

    def train(
        self,
        frame: Frame,
        valid: Optional[Frame] = None,
        job=None,
    ) -> Grid:
        self.device = resolve_device(getattr(self.params, "device", None))
        return self._execute(Grid(), frame, valid, job=job)

    def _execute(self, grid: Grid, frame: Frame, valid: Optional[Frame],
                 job=None) -> Grid:
        """Run the walk. The JAX package fans the cells across a live
        multi-member cloud here; this package has no cloud yet (ROADMAP
        A10), so it always takes the local walk, the JAX package's own
        path when no cloud is live."""
        return self._run(grid, frame, valid, job=job)

    def n_cells_hint(self) -> int:
        """Planned cell count (for progress fractions): the hyper product
        capped by max_models. Early stopping can finish under it."""
        sizes = [len(v) for v in self.hyper_params.values()]
        total = int(np.prod(sizes)) if sizes else 0
        if self.criteria.max_models:
            total = min(total, self.criteria.max_models)
        return total

    def _walk(self):
        """The canonical cell walk, in the strategy's order. (The JAX
        package also skips the cells a recovery snapshot consumed; see
        ``recovery_dir``.)"""
        c = self.criteria
        if c.strategy.lower() == "cartesian":
            return _cartesian(self.hyper_params)
        if c.strategy.lower() in ("randomdiscrete", "random_discrete"):
            return _random_discrete(self.hyper_params, c.seed)
        raise ValueError(f"unknown strategy {c.strategy!r}")

    def _stopped_early(self, scores: List[float], direction) -> bool:
        """ScoreKeeper.stopEarly over the finished-model metric sequence:
        stop when the best of the last ``stopping_rounds`` models does not
        improve on the best before them by ``stopping_tolerance``
        (relative)."""
        c = self.criteria
        k = c.stopping_rounds
        if not k or len(scores) < 2 * k:
            return False
        arr = np.array(scores, dtype=np.float64)
        if not direction["larger"]:
            arr = -arr
        recent = np.max(arr[-k:])
        before = np.max(arr[:-k])
        improvement = (recent - before) / max(abs(before), 1e-12)
        return improvement < c.stopping_tolerance

    def _run(self, grid: Grid, frame: Frame, valid: Optional[Frame],
             job=None) -> Grid:
        scores: List[float] = []
        c = self.criteria
        t0 = time.time()
        walker = self._walk()
        # the metric direction comes from the first finished model (set in
        # _record)
        direction = {"larger": True}
        n_hint = self.n_cells_hint()

        def build_one(hp: Dict[str, Any]):
            return self.builder_cls(self._cell_params(hp)).train(frame, valid)

        def out_of_budget() -> bool:
            if c.max_models and len(grid.models) >= c.max_models:
                return True
            if c.max_runtime_secs and time.time() - t0 >= c.max_runtime_secs:
                return True
            return False

        def stopped_early() -> bool:
            return self._stopped_early(scores, direction)

        if self.parallelism == 1:
            for hp in walker:
                if out_of_budget() or stopped_early():
                    break
                if job is not None and job.stop_requested:
                    break
                self._build_into(grid, hp, build_one, scores, c, direction)
                if job is not None and n_hint:
                    job.update(
                        (len(grid.models) + len(grid.failures)) / n_hint)
        else:
            with ThreadPoolExecutor(max_workers=self.parallelism) as pool:
                pending = []
                for hp in walker:
                    if out_of_budget() or stopped_early():
                        break
                    pending.append((hp, pool.submit(build_one, hp)))
                    if len(pending) >= self.parallelism:
                        self._drain(grid, pending, scores, c, direction)
                        pending = []
                self._drain(grid, pending, scores, c, direction)

        grid.runtime_secs = time.time() - t0
        return grid

    def _record(self, grid, hp, m, scores, c, direction) -> None:
        grid.models.append(m)
        grid.hyper_params.append(hp)
        v, larger = metric_value(m, c.stopping_metric)
        scores.append(v)
        direction["larger"] = larger

    def _build_into(self, grid, hp, build_one, scores, c, direction) -> None:
        try:
            m = build_one(hp)
            self._record(grid, hp, m, scores, c, direction)
        except Exception as e:  # failed combos are recorded, not fatal
            grid.failures.append((hp, f"{type(e).__name__}: {e}"))

    def _drain(self, grid, pending, scores, c, direction) -> None:
        for hp, fut in pending:
            try:
                m = fut.result()
                self._record(grid, hp, m, scores, c, direction)
            except Exception as e:
                grid.failures.append((hp, f"{type(e).__name__}: {e}"))
