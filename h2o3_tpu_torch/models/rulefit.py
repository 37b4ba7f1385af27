"""RuleFit — the port of ``h2o3_tpu/models/rulefit.py``: rules from tree
ensembles plus a sparse linear model.

Reference: ``hex/rulefit/RuleFit.java:34`` — (1) train tree ensembles (GBM
or DRF) over a ladder of depths (min_rule_length..max_rule_length); (2)
take every root-to-node path as a binary rule
(``hex/rulefit/RuleExtractor.java``); (3) drop duplicate rules; (4) fit a
LASSO GLM on the rule indicators (and, with ``rules_and_linear``, the
winsorized linear terms); (5) rank the rules by |coefficient|.

The tree ensembles and the LASSO run on the device the build resolved
once, in ``train``: every inner ``GBM``, ``DRF`` and ``GLM`` is given that
``torch.device``, so a RuleFit asked for the CPU fits its inner models on
the CPU (``use_device`` blocks are per thread and an inner builder would
otherwise resolve its own). The rules are read from the trees' host arrays
(``split_bin`` into ``edges``) and evaluated on the host ``tree_matrix``,
as in the JAX package; the rule frame holds one float64 column per rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters
from h2o3_tpu_torch.models.glm import GLM, GLMModel


@dataclass
class RuleCondition:
    feature: int  # design-matrix column index
    feature_name: str
    threshold: float  # raw-space threshold from the bin edges
    go_left: bool  # True: x < threshold (NA follows na_left)
    na_left: bool

    def describe(self) -> str:
        op = "<" if self.go_left else ">="
        return f"({self.feature_name} {op} {self.threshold:.6g})"


@dataclass
class Rule:
    conditions: List[RuleCondition]
    support: float = 0.0
    coefficient: float = 0.0

    def key(self) -> Tuple:
        return tuple(
            (c.feature, round(c.threshold, 10), c.go_left, c.na_left)
            for c in sorted(self.conditions, key=lambda c: (c.feature, c.threshold))
        )

    def describe(self) -> str:
        return " & ".join(c.describe() for c in self.conditions)

    def evaluate(self, X: np.ndarray) -> np.ndarray:
        m = np.ones(X.shape[0], dtype=bool)
        for c in self.conditions:
            x = X[:, c.feature]
            na = np.isnan(x)
            left = np.where(na, c.na_left, x < c.threshold)
            m &= left if c.go_left else ~left
        return m


@dataclass
class RuleFitParameters(ModelParameters):
    algorithm: str = "gbm"  # gbm | drf
    min_rule_length: int = 3
    max_rule_length: int = 3
    max_num_rules: int = -1  # -1: keep what the LASSO selects
    model_type: str = "rules_and_linear"  # rules_and_linear | rules | linear
    rule_generation_ntrees: int = 50
    distribution: str = "auto"
    lambda_: Optional[float] = None  # None: _auto_lambda


class RuleFitModel(Model):
    algo_name = "rulefit"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.rules: List[Rule] = []
        self.linear_names: List[str] = []
        self.glm: Optional[GLMModel] = None
        self.rule_importance: List[Dict] = []
        self.winsor: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def _rule_frame(self, frame: Frame) -> Frame:
        from h2o3_tpu_torch.models.tree.common import tree_matrix

        X = tree_matrix(self.data_info, frame)
        cols = []
        for ri, r in enumerate(self.rules):
            cols.append(Column(f"rule_{ri}", r.evaluate(X).astype(np.float64), ColType.NUM))
        if self.params.model_type in ("rules_and_linear", "linear"):
            lo, hi = self.winsor
            for j, nm in enumerate(self.linear_names):
                x = np.clip(X[:, j], lo[j], hi[j])
                x = np.where(np.isnan(X[:, j]), np.nan, x)
                cols.append(Column(f"linear_{nm}", x, ColType.NUM))
        return Frame(cols)

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        return self.glm._predict_raw(self._rule_frame(frame))


class RuleFit(ModelBuilder):
    algo_name = "rulefit"

    def __init__(self, params: Optional[RuleFitParameters] = None, **kw) -> None:
        super().__init__(params or RuleFitParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: RuleFitParameters = self.params
        if p.min_rule_length > p.max_rule_length:
            raise ValueError("min_rule_length must be <= max_rule_length")
        if p.model_type not in ("rules_and_linear", "rules", "linear"):
            raise ValueError(f"bad model_type {p.model_type!r}")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> RuleFitModel:
        from h2o3_tpu_torch.models.tree.common import tree_data_info, tree_matrix

        p: RuleFitParameters = self.params
        info = tree_data_info(frame, p.response_column, ignored=p.ignored_columns)
        model = RuleFitModel(p, info, device)
        X = tree_matrix(info, frame)
        nclasses = len(info.response_domain) if info.response_domain else 1

        rules: List[Rule] = []
        if p.model_type != "linear":
            ntrees_per_depth = max(p.rule_generation_ntrees // max(
                p.max_rule_length - p.min_rule_length + 1, 1), 1)
            for depth in range(p.min_rule_length, p.max_rule_length + 1):
                ens = self._tree_ensemble(frame, depth, ntrees_per_depth, device)
                rules += _extract_rules(ens, info)
            # drop duplicates and rules of degenerate support
            seen = {}
            for r in rules:
                sup = r.evaluate(X).mean()
                if 0.005 < sup < 0.995:
                    r.support = float(sup)
                    seen.setdefault(r.key(), r)
            rules = list(seen.values())
        model.rules = rules
        model.linear_names = list(info.coef_names)
        lo = np.nanquantile(X, 0.025, axis=0)
        hi = np.nanquantile(X, 0.975, axis=0)
        model.winsor = (lo, hi)

        rf = model._rule_frame(frame)
        rf = rf.add_column(frame.col(p.response_column).copy())
        family = (
            "gaussian" if nclasses == 1 else ("binomial" if nclasses == 2 else "multinomial")
        )
        lam = p.lambda_ if p.lambda_ is not None else _auto_lambda(rf, p)
        model.glm = GLM(
            response_column=p.response_column, family=family, alpha=1.0,
            lambda_=lam, seed=p.actual_seed(), device=device,
        ).train(rf)

        model.rule_importance = _rule_importance(model)

        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model

    def _tree_ensemble(self, frame: Frame, depth: int, ntrees: int,
                       device: torch.device):
        p: RuleFitParameters = self.params
        kw = dict(
            response_column=p.response_column, ntrees=ntrees, max_depth=depth,
            seed=p.actual_seed() + depth, ignored_columns=list(p.ignored_columns),
            device=device,
        )
        if p.algorithm == "gbm":
            from h2o3_tpu_torch.models.tree.gbm import GBM

            return GBM(**kw).train(frame)
        from h2o3_tpu_torch.models.tree.drf import DRF

        return DRF(**kw).train(frame)


def _extract_rules(tree_model, info) -> List[Rule]:
    """Every root-to-node path of every tree is a rule
    (hex/rulefit/RuleExtractor.java walks all nodes, not just leaves)."""
    out: List[Rule] = []
    booster = tree_model.booster
    edges = booster.trees_per_class[0].edges
    names = info.coef_names
    for trees in booster.trees_per_class:
        for t in range(trees.ntrees):
            feat, sb = trees.feat[t], trees.split_bin[t]
            dl, sp = trees.default_left[t], trees.is_split[t]

            def walk(node: int, conds: List[RuleCondition]):
                if conds:
                    out.append(Rule(list(conds)))
                if node >= len(sp) or not sp[node]:
                    return
                f = int(feat[node])
                b = int(sb[node])
                # the split sends bin <= b left, i.e. x <= edges[b]; b ==
                # nbins-1 is the split with every non-NA row left (NA only
                # right): threshold +inf
                thr = float(edges[f][b]) if b < edges.shape[1] else float("inf")
                na_l = bool(dl[node])
                left = RuleCondition(f, names[f] if f < len(names) else f"C{f}", thr, True, na_l)
                right = RuleCondition(f, names[f] if f < len(names) else f"C{f}", thr, False, na_l)
                walk(2 * node + 1, conds + [left])
                walk(2 * node + 2, conds + [right])

            walk(0, [])
    return out


def _rule_importance(model: RuleFitModel) -> List[Dict]:
    """The importance table from the LASSO's coefficients (the reference
    sorts by |coef|, with the rule text); sets each rule's coefficient."""
    imp = []
    coefs = model.glm.coefficients
    for ri, r in enumerate(model.rules):
        c = coefs.get(f"rule_{ri}", 0.0)
        r.coefficient = c
        if c != 0.0:
            imp.append({"variable": f"rule_{ri}", "coefficient": c,
                        "rule": r.describe(), "support": r.support})
    for nm in model.linear_names:
        c = coefs.get(f"linear_{nm}", 0.0)
        if c != 0.0:
            imp.append({"variable": f"linear_{nm}", "coefficient": c,
                        "rule": f"linear({nm})", "support": 1.0})
    imp.sort(key=lambda d: -abs(d["coefficient"]))
    if model.params.max_num_rules > 0:
        imp = imp[: model.params.max_num_rules]
    return imp


def _auto_lambda(rf: Frame, p: RuleFitParameters) -> float:
    """A small fixed lambda (the reference runs a lambda search; one
    conservative point keeps the fit sparse and quick)."""
    n = rf.nrows
    return 1.0 / max(np.sqrt(n), 1.0) * 0.5
