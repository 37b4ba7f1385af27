"""Parity: the PyTorch port's map/reduce core and Rapids engine
(``h2o3_tpu_torch/compute/``, ``h2o3_tpu_torch/rapids/``,
``frame/rollups.py``) against the JAX package, on the CPU.

Each test builds its data with numpy, runs the JAX package and the port on
the same data, and holds:

- the parser: the same ASTs and ``canonical_sexpr`` strings;
- every fusible prim on the special-values frame of the JAX package's
  fusion suite: the port fused (where its emit fuses on the CPU) and the
  port's interpreter bitwise equal to the JAX package's fused result;
  broadcasting, unfusible replay, the warm path, invalidation and raised
  errors as ``tests/test_rapids_fusion.py`` holds them;
- with ``DIST_SORT_MIN`` lowered to 1 in both packages: ``sort``
  (multi-key, descending, NaN, signed zeros, ties) and ``merge`` (inner,
  ``all_left``, ``all_right``) equal; ``GB``'s counts, min and max equal
  and its moments at the device-against-host tolerances of
  ``tests/test_dist_munging.py``; the munging prims equal;
- ``map_reduce`` (sum, max, min), ``map_batches``, the frame table cache,
  ``quantiles`` bit for bit (an outlier-dominated range too),
  ``sketch_column``, ``merge_edges``, rollups of NUM, CAT, TIME and STR
  columns, and ``x`` above a lowered ``_DEVICE_MIN_ELEMS`` at rtol 1e-5;
- a failure on a device path (a ``dist`` function or the fused dispatch
  made to raise) propagates out of ``exec_rapids``: no host answer;
- the registry: the port's prims are the JAX package's, and a name neither
  registers raises ``unknown function``;
- every prim of ``search``, ``strings``, ``times``, ``advmath`` and
  ``models`` on one seeded frame (NUM with NaN, CAT with NAs whose levels
  collapse under ``tolower``, STR with ``None``, date strings, TIME stamps
  on both sides of New York's 2021 DST changes): the port's CPU session
  and its interpreter bit for bit against the JAX package (values, types,
  domains, names), fused comparisons feeding host prims, the time fields
  in UTC and in America/New_York, ``impute`` by groups, every ``distance``
  measure, the seeded random columns, and the JAX package's errors;
  ``PermutationVarImp`` of a JAX GLM carried across by
  ``convert.glm_from_numpy``, per variable at atol 1e-6 (its order only
  where neighbours part by more).

Under jax 0.9.0, ``jax.experimental`` has no ``enable_x64``, which the JAX
package's ``rapids/fusion.py`` and ``rapids/dist_exec.py`` import. This
file binds it to a context manager over ``jax.enable_x64(True)`` before
anything imports ``h2o3_tpu.rapids``, and only where the name is missing.
"""

import contextlib
import dataclasses
import os

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64():
        with jax.enable_x64(True):
            yield

    jax.experimental.enable_x64 = _enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from h2o3_tpu.compute import mapreduce as j_mr  # noqa: E402
from h2o3_tpu.compute import quantile as j_q  # noqa: E402
from h2o3_tpu.frame import frame as j_frame  # noqa: E402
from h2o3_tpu.frame import rollups as j_roll  # noqa: E402
from h2o3_tpu.rapids import Session as JSession  # noqa: E402
from h2o3_tpu.rapids import dist as j_dist  # noqa: E402
from h2o3_tpu.rapids import exec_rapids as j_exec  # noqa: E402
from h2o3_tpu.rapids import parser as j_parser  # noqa: E402
from h2o3_tpu.rapids.prims import FUSIBLE as J_FUSIBLE  # noqa: E402
from h2o3_tpu.rapids.prims import PRIMS as J_PRIMS  # noqa: E402
from h2o3_tpu.rapids.prims import matrix as j_matrix  # noqa: E402
from h2o3_tpu.util import telemetry  # noqa: E402
from h2o3_tpu_torch.compute import mapreduce as t_mr  # noqa: E402
from h2o3_tpu_torch.compute import quantile as t_q  # noqa: E402
from h2o3_tpu_torch.frame import devcache as t_devcache  # noqa: E402
from h2o3_tpu_torch.frame import frame as t_frame  # noqa: E402
from h2o3_tpu_torch.frame import rollups as t_roll  # noqa: E402
from h2o3_tpu_torch.rapids import Session as TSession  # noqa: E402
from h2o3_tpu_torch.rapids import dist as t_dist  # noqa: E402
from h2o3_tpu_torch.rapids import exec_rapids as t_exec  # noqa: E402
from h2o3_tpu_torch.rapids import fusion as t_fusion  # noqa: E402
from h2o3_tpu_torch.rapids import parser as t_parser  # noqa: E402
from h2o3_tpu_torch.rapids.prims import FUSIBLE as T_FUSIBLE  # noqa: E402
from h2o3_tpu_torch.rapids.prims import PRIMS as T_PRIMS  # noqa: E402
from h2o3_tpu_torch.rapids.prims import matrix as t_matrix  # noqa: E402

torch.set_num_threads(1)

#: one fused-region expression per fusible prim (the JAX package's suite)
PARITY_CASES = {
    "+": '(+ (cols_py pf 0) (cols_py pf 1))',
    "-": '(- (cols_py pf 0) (cols_py pf 1))',
    "*": '(* (cols_py pf 0) (cols_py pf 1))',
    "/": '(/ (cols_py pf 0) (cols_py pf 1))',
    "%": '(% (cols_py pf 0) (cols_py pf 1))',
    "%%": '(%% (cols_py pf 0) (cols_py pf 1))',
    "intDiv": '(intDiv (cols_py pf 0) (cols_py pf 1))',
    "%/%": '(%/% (cols_py pf 0) (cols_py pf 1))',
    "==": '(== (cols_py pf 0) (cols_py pf 1))',
    "!=": '(!= (cols_py pf 0) (cols_py pf 1))',
    "<": '(< (cols_py pf 0) (cols_py pf 1))',
    "<=": '(<= (cols_py pf 0) (cols_py pf 1))',
    ">": '(> (cols_py pf 0) (cols_py pf 1))',
    ">=": '(>= (cols_py pf 0) (cols_py pf 1))',
    "&": '(& (cols_py pf 0) (cols_py pf 1))',
    "&&": '(&& (cols_py pf 0) (cols_py pf 1))',
    "|": '(| (cols_py pf 0) (cols_py pf 1))',
    "||": '(|| (cols_py pf 0) (cols_py pf 1))',
    "not": '(not (cols_py pf 0))',
    "ifelse": '(ifelse (> (cols_py pf 0) 0) (cols_py pf 0) (cols_py pf 1))',
    "abs": '(abs (cols_py pf 0))',
    "ceiling": '(ceiling (cols_py pf 0))',
    "floor": '(floor (cols_py pf 0))',
    "trunc": '(trunc (cols_py pf 0))',
    "round": '(round (cols_py pf 0) 0)',
    "sqrt": '(sqrt (cols_py pf 0))',
    "sign": '(sign (cols_py pf 0))',
    "sgn": '(sgn (cols_py pf 0))',
    "sin": '(sin (cols_py pf 0))',
    "cos": '(cos (cols_py pf 0))',
    "sinpi": '(sinpi (cols_py pf 0))',
    "cospi": '(cospi (cols_py pf 0))',
    "none": '(none (cols_py pf 0))',
    "is.na": '(is.na (cols_py pf 0))',
    "cols": '(* (cols pf [0]) 2)',
    "cols_py": '(* (cols_py pf 1) 2)',
    "max": '(max (* (cols_py pf 0) 2))',
    "maxNA": '(maxNA (* (cols_py pf 0) 2))',
    "min": '(min (* (cols_py pf 0) 2))',
    "minNA": '(minNA (* (cols_py pf 0) 2))',
    "sum": '(sum (* (cols_py pf 0) 2))',
    "sumNA": '(sumNA (* (cols_py pf 0) 2))',
    "prod": '(prod (* (cols_py pf 0) 0))',
    "prodNA": '(prodNA (ifelse (is.na (cols_py pf 0)) 1 2))',
    "mean": '(mean (* (cols_py pf 0) 2))',
}


def bits_equal(a, b):
    """Bitwise float64 equality, NaN-payload exempt (both-NaN is equal)."""
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    if a.shape != b.shape:
        return False
    bad = (a.view(np.uint64) != b.view(np.uint64)) & ~(np.isnan(a) & np.isnan(b))
    return not bad.any()


def assert_same_frame(jf, tf, ctx="", moments=None):
    """Equal names, types, domains and values; ``moments`` maps a column
    name to (rtol, atol) where values are held at a tolerance instead."""
    assert jf.names == tf.names, ctx
    for jc, tc in zip(jf.columns, tf.columns):
        assert jc.type.value == tc.type.value, (ctx, jc.name)
        assert jc.domain == tc.domain, (ctx, jc.name)
        if jc.data.dtype == object:
            assert list(jc.data) == list(tc.data), (ctx, jc.name)
        elif moments and jc.name in moments:
            rtol, atol = moments[jc.name]
            np.testing.assert_allclose(tc.numeric_view(), jc.numeric_view(), rtol=rtol,
                                       atol=atol, err_msg=f"{ctx} {jc.name}")
        else:
            assert bits_equal(jc.numeric_view(), tc.numeric_view()), (ctx, jc.name)


def assert_same_val(jv, tv, ctx=""):
    assert jv.kind == tv.kind, (ctx, jv, tv)
    if jv.is_frame():
        assert_same_frame(jv.value, tv.value, ctx)
    elif jv.kind == jv.ROW:
        assert bits_equal(jv.value[0], tv.value[0]) and jv.value[1] == tv.value[1], ctx
    elif jv.kind in (jv.STR, jv.STRS):
        assert jv.value == tv.value, ctx
    else:
        assert bits_equal(jv.value, tv.value), (ctx, jv.value, tv.value)


def both(columns):
    """The same columns as a JAX-package Frame and a port Frame;
    ``columns`` is a list of (name, data, type name, domain)."""
    def make(mod):
        return mod.Frame([mod.Column(n, np.array(d, copy=True), mod.ColType[t], dom)
                          for n, d, t, dom in columns])

    return make(j_frame), make(t_frame)


def special_columns():
    """The special-values frame of the JAX package's fusion suite."""
    a = [1.5, -2.5, np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0, -3.0, 7.25,
         -7.25, 2.0, 1e300, -1e-300, 5.0, -5.5, -1.0, 0.5, -0.25, 9.0]
    b = [2.0, -3.0, 1.0, 2.0, 2.0, -0.0, 0.0, -2.0, np.nan, np.inf,
         -np.inf, 0.5, 1e-300, 1e300, -5.0, 5.5, np.inf, -0.0, 4.0, -9.0]
    rng = np.random.default_rng(11)
    ra = rng.standard_normal(200) * 10
    rb = rng.standard_normal(200) * 10
    ra[::13] = np.nan
    rb[::17] = np.nan
    return [("a", np.concatenate([a, ra]), "NUM", None),
            ("b", np.concatenate([b, rb]), "NUM", None)]


def jax_fused():
    c = telemetry.REGISTRY.get("rapids_fusion_total")
    return float(c.value(result="fused")) if c is not None else 0.0


class Sessions:
    """A JAX-package session (fusion on), a port session on the CPU and
    the port's plain interpreter, with the frames assigned to all three;
    ``close`` removes the keys."""

    def __init__(self, **port_kw):
        self.j = JSession()
        self.t = TSession(device="cpu", **port_kw)
        self.p = TSession(device="cpu", fusion=False)
        self.keys = []

    def assign(self, key, columns):
        jf, tf = both(columns)
        self.j.assign(key, jf)
        self.t.assign(key, tf)
        self.keys.append(key)
        return jf, tf

    def run(self, expr):
        """(JAX fused, port fused, port interpreted, port regions fused)."""
        f0 = t_fusion.COUNTS["fused"]
        tv = t_exec(expr, self.t)
        fused = t_fusion.COUNTS["fused"] - f0
        return j_exec(expr, self.j), tv, t_exec(expr, self.p), fused

    def close(self):
        for k in self.keys:
            self.j.remove(k)
            self.t.remove(k)


def test_parser_and_fusion_match_jax(monkeypatch):
    # -- the parser: the same ASTs, the same canonical strings
    def shape(node):
        fields = getattr(node, "__dataclass_fields__", None)
        if fields is None:
            if isinstance(node, np.ndarray):
                return ("arr", node.tobytes())
            if isinstance(node, list):
                return tuple(shape(x) for x in node)
            return node if not isinstance(node, float) or node == node else "nan"
        return (type(node).__name__,) + tuple(shape(getattr(node, f)) for f in fields)

    for text in ('(+ (cols_py fr 0) 1.5)', "(tmp= x (sort fr [0 2:3 1:2:4] [1 0]))",
                 '(GB fr [0] "mean" 1 "rm" "nrow" 0 "all")',
                 "(apply fr 1 {row . (sum (* row 2))})", "[]", "NaN", "(x a b)",
                 "(== fr 'lvl\\'x')", '(cols fr ["a" "b"])', "(round fr -2e-3)"):
        jn, tn = j_parser.parse(text), t_parser.parse(text)
        assert shape(jn) == shape(tn), text
        assert j_parser.canonical_sexpr(jn) == t_parser.canonical_sexpr(tn), text
    for bad in ("(+ 1", "[1 'a']", "{x (+ x 1)}", "(+ 1) 2", '"open'):
        with pytest.raises(j_parser.RapidsParseError):
            j_parser.parse(bad)
        with pytest.raises(t_parser.RapidsParseError):
            t_parser.parse(bad)
    # -- the registries: the same prims and the same fusible prims; a name
    # neither registers raises unknown function in both packages
    assert set(T_PRIMS) == set(J_PRIMS)
    assert set(T_FUSIBLE) == set(J_FUSIBLE) == set(PARITY_CASES)
    for name, spec in T_FUSIBLE.items():
        assert spec.kind == J_FUSIBLE[name].kind, name
        assert (spec.emit is None) == (J_FUSIBLE[name].emit is None), name
    s = Sessions()
    try:
        s.assign("pf", special_columns())
        for run in (lambda e: j_exec(e, s.j), lambda e: t_exec(e, s.t)):
            with pytest.raises(ValueError, match="unknown function 'no_such_prim'") as ei:
                run("(no_such_prim pf)")
            assert type(ei.value).__name__ == "RapidsError"
        # -- every fusible prim, bitwise against the JAX package's fused run
        for name, expr in sorted(PARITY_CASES.items()):
            j0 = jax_fused()
            jv, tv, pv, fused = s.run(expr)
            assert jax_fused() > j0, name
            assert_same_val(jv, tv, name)
            assert_same_val(pv, tv, name)
            spec = T_FUSIBLE[name]
            assert (fused >= 1) == (spec.kind not in ("binop", "uniop", "ifelse")
                                    or "cpu" in spec.devices), (name, fused)
        # -- broadcasting, region boundaries, scalar leaves, pow unfused
        s.assign("one", [("k", [2.0], "NUM", None)])
        back0 = t_fusion.COUNTS["fallback"]
        for expr in ("(* (+ pf 1) 2)", "(- 1 (/ 2 pf))", "(* (+ pf 0) (cols_py pf 1))",
                     "(sum (* (log1p (abs (cols_py pf 0))) 2))",
                     "(sum (* (^ (cols_py pf 0) 2) 3))",
                     "(* (- (cols_py pf 0) (mean (cols_py pf 0))) 2)",
                     "(* (+ (cols_py pf 0) one) 3)", "(+ 1 (* 2 3))"):
            jv, tv, pv, fused = s.run(expr)
            assert_same_val(jv, tv, expr)
            assert_same_val(pv, tv, expr)
        assert t_fusion.COUNTS["fallback"] == back0 + 1  # the 1-row frame
        assert "^" not in T_FUSIBLE
        # -- errors raise the same way fused and not, in both packages
        for expr, err in (("(* (cols_py pf 1) (+ pf 0))", "duplicate column names"),):
            for run in (lambda e: j_exec(e, s.j), lambda e: t_exec(e, s.t),
                        lambda e: t_exec(e, s.p)):
                with pytest.raises(ValueError, match=err):
                    run(expr)
        strs = np.array(["p", "q", None, "r"] * 2, dtype=object)
        s.assign("fs", [("x", np.arange(8.0), "NUM", None), ("s", strs, "STR", None)])
        kinds = set()
        for run in (lambda e: j_exec(e, s.j), lambda e: t_exec(e, s.t)):
            with pytest.raises(Exception) as ei:
                run("(* (+ fs 1) 2)")
            kinds.add(type(ei.value).__name__)
        assert len(kinds) == 1
        jv, tv, pv, _ = s.run("(cols (cols fs [0 1]) [1])")
        assert_same_val(jv, tv)
        assert tv.value.col(0).type is t_frame.ColType.STR
        cat = np.array([0, 1, -1, 2, 1, 0] * 4, dtype=np.int32)
        s.assign("fc", [("x", np.arange(24.0), "NUM", None),
                        ("c", cat, "CAT", ["lo", "mid", "hi"])])
        for expr in ("(* (+ (cols_py fc 1) 1) 2)", "(cols (cols fc [0 1]) [1])",
                     "(ifelse (> (cols_py fc 0) 10) (cols_py fc 1) (cols_py fc 1))",
                     '(== (cols_py fc 1) "mid")'):
            jv, tv, pv, _ = s.run(expr)
            assert_same_val(jv, tv, expr)
            assert_same_val(pv, tv, expr)
        # -- the warm path plans and uploads nothing; an assignment's new
        # column versions upload again and the result follows the data
        rng = np.random.default_rng(3)
        s.assign("vf", [("u", rng.standard_normal(64), "NUM", None),
                        ("v", rng.standard_normal(64), "NUM", None)])
        expr = "(sum (* (+ (cols_py vf 0) (cols_py vf 1)) 2))"
        before = t_exec(expr, s.t)
        plans = t_mr.plan_stats()["rapids_fusion"]["misses"]
        table = t_devcache.DEVCACHE.stats()["kinds"]["frame_table"]
        assert bits_equal(before.value, t_exec(expr, s.t).value)
        now = t_devcache.DEVCACHE.stats()["kinds"]["frame_table"]
        assert t_mr.plan_stats()["rapids_fusion"]["misses"] == plans
        assert now["misses"] == table["misses"] and now["hits"] > table["hits"]
        assign = "(tmp= vf (:= vf (* (cols_py vf 0) 0.5) [0] _))"
        t_exec(assign, s.t)
        j_exec(assign, s.j)
        after = t_exec(expr, s.t)
        assert t_devcache.DEVCACHE.stats()["kinds"]["frame_table"]["misses"] > now["misses"]
        assert bits_equal(after.value, t_exec(expr, s.p).value)
        assert bits_equal(after.value, j_exec(expr, s.j).value)
        assert not bits_equal(before.value, after.value)
        # -- fusion off, and the fewest ops a region must cover
        f0 = t_fusion.COUNTS["fused"]
        t_exec(expr, s.p)
        t_exec("(+ pf 1)", s.t)  # 1 op: interpreted
        gated = TSession(device="cpu", fusion_min_ops=5)
        t_exec("(* (+ pf 1) 2)", gated)
        assert t_fusion.COUNTS["fused"] == f0
        t_exec("(* (+ pf 1) 2)", s.t)
        assert t_fusion.COUNTS["fused"] == f0 + 1
    finally:
        s.close()


def _munge_columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, n).astype(np.float64) * 0.5  # ties
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.05] = 0.0
    g = rng.integers(0, 5, n).astype(np.int32)
    g[rng.random(n) < 0.03] = -1
    v = rng.normal(size=n) * 3 + 1
    v[rng.random(n) < 0.04] = np.nan
    s = np.array([None if r < 0.05 else f"s{int(r * 7)}" for r in rng.random(n)],
                 dtype=object)
    return [("x", x, "NUM", None), ("g", g, "CAT", list("abcde")), ("v", v, "NUM", None),
            ("s", s, "STR", None), ("rid", np.arange(n, dtype=np.float64), "NUM", None),
            ("t", 1.6e12 + rng.integers(0, 10, n) * 3.6e6, "TIME", None)]


#: the JAX package's device-against-host tolerances (tests/test_dist_munging.py)
GB_MOMENTS = {"mean_v": (1e-5, 1e-4), "sum_v": (1e-4, 5e-2), "sd_v": (5e-3, 1e-4),
              "var_v": (1e-2, 1e-4)}


def test_device_sort_merge_group_by_and_mungers_match_jax(monkeypatch):
    monkeypatch.setattr(j_dist, "DIST_SORT_MIN", 1)
    monkeypatch.setattr(t_dist, "DIST_SORT_MIN", 1)
    calls = {}
    for name in ("device_lexsort", "device_argsort_u64", "device_searchsorted_both",
                 "device_group_aggregate"):
        real = getattr(t_dist, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(t_dist, name, counted)
    s = Sessions()
    try:
        s.assign("fr", _munge_columns(3000, 5))
        look = np.array([0, 1, 2, 3], dtype=np.int32)
        s.assign("lk", [("g", look, "CAT", list("abcz")),
                        ("w", np.array([1.0, np.nan, -0.0, 4.0]), "NUM", None)])
        s.assign("rk", [("g", np.array([0, 0, 4, 2], dtype=np.int32), "CAT", list("abcde")),
                        ("w", np.array([1.0, 2.0, 3.0, 4.0]), "NUM", None)])
        # -- sort: multi-key, descending, NaN first, -0 ties +0, stable
        for expr in ("(sort fr [0] [1])", "(sort fr [1 0] [1 0])", "(sort fr [0 2] [0 1])",
                     "(sort fr [3 0] [1 1])"):
            jv, tv, _, _ = s.run(expr)
            assert_same_val(jv, tv, expr)
            with monkeypatch.context() as m:
                m.setattr(t_dist, "DIST_SORT_MIN", 1 << 60)
                assert_same_val(t_exec(expr, s.p), tv, expr)
        # -- merge: inner, all_left, all_right, on named and default keys
        for expr in ("(merge fr lk 0 0 [] [] \"auto\")", "(merge fr lk 1 0 [] [] \"auto\")",
                     "(merge fr rk 0 1 [1] [0] \"auto\")", "(merge lk fr 1 1 [0] [1] \"auto\")"):
            jv, tv, _, _ = s.run(expr)
            assert_same_val(jv, tv, expr)
            with monkeypatch.context() as m:
                m.setattr(t_dist, "DIST_SORT_MIN", 1 << 60)
                assert_same_val(t_exec(expr, s.p), tv, expr)
        # -- group-by: counts, min and max equal, moments at the tolerances
        aggs = " ".join(f'"{a}" 2 "rm"' for a in ("nrow", "mean", "sum", "min", "max",
                                                     "sd", "var"))
        for by in ("[1]", "[1 0]", "[3]"):
            expr = f"(GB fr {by} {aggs})"
            jv, tv, _, _ = s.run(expr)
            assert_same_frame(jv.value, tv.value, expr, moments=GB_MOMENTS)
            assert bits_equal(tv.value.col("nrow").data, jv.value.col("nrow").data)
            assert_same_frame(tv.value, t_exec(expr, s.t).value, expr)  # same bits twice
            with monkeypatch.context() as m:
                m.setattr(t_dist, "DIST_SORT_MIN", 1 << 60)
                host = t_exec(expr, s.p).value
            assert_same_frame(host, tv.value, expr,
                              moments=dict(GB_MOMENTS, min_v=(1e-6, 1e-6),
                                           max_v=(1e-6, 1e-6)))
        jv, tv, _, _ = s.run('(GB fr [1] "nrow" 0 "all" "median" 2 "rm" "mode" 1 "all")')
        assert_same_val(jv, tv)
        assert calls["device_lexsort"] >= 4 and calls["device_searchsorted_both"] >= 4
        assert calls["device_group_aggregate"] >= 6
        # -- the munging prims on the host, equal to the JAX package's
        for expr in (
                "(cbind fr (cols fr [0]))", "(rbind fr fr)", "(rows fr [0 5 7])",
                "(rows fr (> (cols fr [0]) 0))", "(as.factor (cols fr [0]))",
                "(as.numeric (cols fr [1]))", "(as.character (cols fr [0 1]))",
                "(levels (cols fr [1]))", "(nlevels fr)", '(relevel (cols fr [1]) "c")',
                '(setLevel (cols fr [1]) "b")', "(is.na fr)", "(na.omit fr)",
                '(h2o.fillna (cols fr [0 2]) "forward" 0 2)', "(cut (cols fr [2]) [-5 0 2 9])",
                "(scale (cols fr [0 2]) 1 1)", "(ddply fr [1] {g . (sum (cols g [2]))})",
                '(rankWithinGroupBy fr [1] [2] [1] "r")', "(dropdup fr [1 0] \"last\")",
                '(melt fr [1] [0 2] "var" "val" 1)', "(apply (cols fr [0 2]) 2 {c . (mean c)})",
                '(append fr 3 "k")', "(:= fr 9 [0] [1 2 3])", '(colnames= fr [0] ["xx"])',
                '(rename fr "x" "y")', "(flatten (rows (cols fr [2]) [3]))",
                "(getrow (rows (cols fr [0 2]) [4]))", '(columnsByType fr "numeric")',
                "(filterNACols fr 0.04)", "(cumsum (cols fr [0 2]))", "(sumaxis fr 1 0)",
                "(topn fr 2 5 1)", "(naCnt fr)", "(any.na fr)", "(median (cols fr [2]))",
                "(sd (cols fr [2]))", "(mad (cols fr [2]))", "(all (cols fr [0]) 1)",
                "(signif (cols fr [2]) 3)", "(is.factor fr)", "(ncol fr)",
                "(pivot (rows fr [0 1 2 3]) 4 1 2)", "(nrow (merge fr lk 1 0 [] [] \"auto\"))"):
            jv, tv, _, _ = s.run(expr)
            assert_same_val(jv, tv, expr)
    finally:
        s.close()
    # -- a failure on a device path raises and gives no host answer: the
    # JAX package answers from the host when its device sort, probe,
    # aggregation or fused dispatch fails; the port raises
    def down(*a, **kw):
        raise RuntimeError("device path down")

    sess = TSession(device="cpu")
    cols = _munge_columns(200, 9)
    sess.assign("fr", both(cols)[1])
    sess.assign("lk", both([("g", np.array([0, 1], dtype=np.int32), "CAT", list("ab"))])[1])
    try:
        for name, expr in (("device_lexsort", "(sort fr [0] [1])"),
                           ("device_searchsorted_both", '(merge fr lk 1 0 [] [] "auto")'),
                           ("device_argsort_u64", '(merge fr lk 0 0 [] [] "auto")'),
                           ("device_group_aggregate", '(GB fr [1] "sum" 2 "rm")')):
            with monkeypatch.context() as m:
                m.setattr(t_dist, name, down)
                with pytest.raises(RuntimeError, match="device path down"):
                    t_exec(expr, sess)
        back = t_fusion.COUNTS["fallback"]
        with monkeypatch.context() as m:
            m.setattr(t_fusion, "map_batches", down)
            with pytest.raises(RuntimeError, match="device path down"):
                t_exec("(* (+ (cols_py fr 0) 1) 2)", sess)
        assert t_fusion.COUNTS["fallback"] == back  # no replay on the host
        # a decision made before any launch still takes the host: mode has
        # no device path
        out = t_exec('(GB fr [1] "mode" 2 "all")', sess).value
        assert out.nrows == 6
    finally:
        sess.remove("fr")
        sess.remove("lk")


def _prim_columns(n, seed):
    """NUM with NaN and ties, CAT with NAs whose levels collapse under
    ``tolower``, STR with ``None``, date strings, TIME stamps on both sides
    of the 2021 DST changes in America/New_York, a binary response."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 3
    x[rng.random(n) < 0.05] = np.nan
    y = 0.5 * np.nan_to_num(x) + rng.normal(size=n)
    y[rng.random(n) < 0.04] = np.nan
    k = rng.integers(0, 4, n).astype(np.float64)
    k[rng.random(n) < 0.03] = np.nan
    g = rng.integers(0, 4, n).astype(np.int32)
    g[rng.random(n) < 0.05] = -1
    words = np.array(["the quick fox", "a-b-c", "", "Hello World", "  pad me  ",
                      "xxAxx", "aa bb aa", "Zebra"], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    s[rng.random(n) < 0.06] = None
    # around 2021-03-14 07:00 UTC and 2021-11-07 06:00 UTC (New York's changes)
    base = np.where(rng.random(n) < 0.5, 1615680000000.0, 1636243200000.0)
    t = base + rng.integers(0, 48 * 3600, n) * 1000.0 + rng.integers(0, 1000, n)
    t[rng.random(n) < 0.04] = np.nan
    dates = np.array([None if np.isnan(v) else
                      str(np.datetime64(int(v), "ms").astype("datetime64[s]")).replace("T", " ")
                      for v in t], dtype=object)
    resp = (rng.random(n) < 0.4).astype(np.int32)
    return [("x", x, "NUM", None), ("y", y, "NUM", None), ("k", k, "NUM", None),
            ("g", g, "CAT", ["Ab", "ab", " cd ", "EF"]), ("s", s, "STR", None),
            ("d", dates, "STR", None), ("t", t, "TIME", None),
            ("r", resp, "CAT", ["no", "yes"])]


def _same_error(s, expr, jexpr=None, message=True):
    """Both packages raise the same exception type, with the same message
    unless ``message`` is false (a message holding an object's repr)."""
    errs = []
    for run, e in ((lambda e: j_exec(e, s.j), jexpr or expr), (lambda e: t_exec(e, s.t), expr)):
        with pytest.raises(Exception) as ei:
            run(e)
        errs.append((type(ei.value).__name__, str(ei.value) if message else ""))
    assert errs[0] == errs[1], (expr, errs)
    return errs[0]


def _check_search_and_strings(s, tmp_path):
    for expr in (
            # a fused comparison on the session's device feeds a host prim
            "(which (& (> (cols_py pp 0) 0) (< (cols_py pp 1) 1)))",
            "(which (cols_py pp 7))", "(match (cols_py pp 2) [3 1 3] NaN 1)",
            '(match (cols_py pp 3) ["ab" "EF" "ab" "zz"] -1 0)',
            '(match (cols_py pp 4) ["Zebra" "" "a-b-c"])', "(which.max (cols pp [0 1]))",
            "(which.min (cols pp [0 1]) 1 1)", "(which.max (* (cols pp [0 1]) -1) 1 1)",
            # the CAT domain path (tolower collapses Ab/ab) and the STR path
            "(tolower (cols pp [3 4]))", "(toupper (cols pp [3 4]))", "(trim (cols pp [3 4]))",
            '(lstrip (cols pp [3 4]) " x")', '(rstrip (cols pp [3 4]) " x")',
            "(lstrip (cols_py pp 4))", "(rstrip (cols_py pp 3))",
            '(replaceall (cols pp [3 4]) "[ab]" "_" 1)', '(replaceall (cols_py pp 4) "a" "")',
            '(replacefirst (cols pp [3 4]) "A" "#" 0)', '(replacefirst (cols_py pp 4) "X" "-" 1)',
            '(strsplit (cols_py pp 4) "[ -]")', '(strsplit (cols_py pp 3) "b")',
            "(substring (cols pp [3 4]) 1 3)", "(substring (cols_py pp 4) -2 NaN)",
            "(substring (cols_py pp 4) 4 2)", "(length (cols pp [3 4]))", "(strlen (cols_py pp 4))",
            "(entropy (cols pp [3 4]))", '(countmatches (cols pp [3 4]) ["a" "x"])',
            '(countmatches (cols_py pp 4) "aa")', '(grep (cols_py pp 4) "a" 0 0 0)',
            '(grep (cols_py pp 4) "^[a-z]" 1 1 1)', '(grep (cols_py pp 3) "b" 0 0 1)',
            '(strDistance (cols_py pp 4) (cols_py pp 5) "lv" 1)',
            '(strDistance (cols_py pp 3) (cols_py pp 4) "Jaccard" 0)',
            '(strDistance (cols_py pp 4) (cols_py pp 3) "jw")',
            '(strDistance (cols_py pp 4) (cols_py pp 4) "jaro_winkler" 0)',
            '(tokenize (cols pp [4 3]) "[ -]")'):
        jv, tv, pv, _ = s.run(expr)
        assert_same_val(jv, tv, expr)
        assert_same_val(pv, tv, expr)
    path = tmp_path / "words.txt"
    path.write_text("the\nfox\nbb\nab\n\nxx\n")
    jv, tv, pv, _ = s.run(f'(num_valid_substrings (cols pp [3 4]) "{path}")')
    assert_same_val(jv, tv)
    assert_same_val(pv, tv)
    for expr in ('(match (cols_py pp 0) ["a"])', '(strDistance (cols_py pp 4) (cols_py pp 4) "x")',
                 '(grep (cols_py pp 0) "a")', "(tolower (cols_py pp 9))"):
        _same_error(s, expr)


def _check_times(s):
    from h2o3_tpu.rapids.prims import times as j_times
    from h2o3_tpu_torch.rapids.prims import times as t_times

    fields = ("year", "month", "day", "dayOfWeek", "hour", "minute", "second", "millis",
              "week")
    s.assign("tp", [("Y", np.array([2021, 2021, np.nan, 1999, 2024, 2021]), "NUM", None),
                    ("M", np.array([2.0, 10, 0, 11, 1, 2]), "NUM", None),
                    ("D", np.array([13.0, 6, 0, 30, 28, 13]), "NUM", None),
                    ("H", np.array([1.0, 1, 5, 23, 12, 2]), "NUM", None),
                    ("Mi", np.array([59.0, 30, 0, 59, 0, 30]), "NUM", None)])
    try:
        for zone in ("UTC", "America/New_York"):
            jv, tv, pv, _ = s.run(f'(setTimeZone "{zone}")')
            assert_same_val(jv, tv, zone)
            assert t_times._TIME_ZONE == j_times._TIME_ZONE == zone
            for expr in ([f"({f} (cols_py pp 6))" for f in fields]
                         + [f"({f} 1615705200123)" for f in fields]
                         + ["(getTimeZone)", "(time (cols_py pp 6))", "(time 1615705200123)",
                            "(mktime (cols_py tp 0) (cols_py tp 1) (cols_py tp 2) "
                            "(cols_py tp 3) (cols_py tp 4) 0 0)",
                            "(mktime 2021 2 13 6 30 15 250)", "(moment 2021 10 6 1 30)",
                            "(year (mktime (cols_py tp 0) (cols_py tp 1) (cols_py tp 2)))",
                            '(as.Date (cols_py pp 5) "yyyy-MM-dd HH:mm:ss")',
                            '(as.Date (as.factor (cols_py pp 5)) "yyyy-MM-dd HH:mm:ss")']):
                jv, tv, pv, _ = s.run(expr)
                assert_same_val(jv, tv, (zone, expr))
                assert_same_val(pv, tv, (zone, expr))
        jv, tv, _, _ = s.run("(listTimeZones)")
        assert_same_val(jv, tv)
        assert "America/New_York" in list(tv.value.col(0).data)
        kind, _ = _same_error(s, '(setTimeZone "Mars/Olympus_Mons")')
        assert t_times._TIME_ZONE == "America/New_York"
        _same_error(s, '(as.Date (cols_py pp 4) "yyyy-MM-dd")')
    finally:
        j_times._TIME_ZONE = t_times._TIME_ZONE = "UTC"
        s.j.remove("tp")
        s.t.remove("tp")
        s.keys.remove("tp")


def _check_advmath(s):
    rng = np.random.default_rng(23)
    s.assign("dr", [(f"c{j}", rng.normal(size=50), "NUM", None) for j in range(3)])
    s.assign("dq", [(f"q{j}", rng.normal(size=7), "NUM", None) for j in range(3)])
    s.assign("dn", [(f"c{j}", np.where(np.arange(7) == 3, np.nan, 1.0), "NUM", None)
                    for j in range(3)])
    docs = np.repeat(np.arange(6.0), 3)
    text = np.array(["the cat sat", "The cat", None, "a dog", "dog dog cat", "sat",
                     "x y", "y", "", "cat", "the", "Dog", "a b", "b a", "c", "q", "q q", None],
                    dtype=object)
    s.assign("tx", [("doc", docs, "NUM", None), ("text", text, "STR", None)])
    series = np.cumsum(rng.normal(size=(12, 16)), axis=1)
    series[2] = 5.0  # a flat row: sd 0
    s.assign("ts", [(f"t{j}", series[:, j], "NUM", None) for j in range(16)])
    os.environ.pop("H2O3_PRIM_PARITY_PROP", None)
    try:
        for expr in (
                "(cor (cols pp [0 1]) (cols pp [0 1]))", '(cor (cols pp [0 1 2]) (cols pp [1]) '
                '"complete.obs")', '(cor (cols_py pp 0) (cols_py pp 1) "complete.obs")',
                "(cor (cols pp [0 1]) (cols pp [2]))", '(spearman pp "x" "y")',
                "(spearman pp 0 2)", "(var (cols pp [0 1 2]))",
                '(var (cols pp [0 1]) (cols pp [2]) "complete.obs")', "(var (cols_py pp 1))",
                "(skewness (cols pp [0 1]) 1)", "(skewness (cols_py pp 0) 0)",
                "(kurtosis (cols pp [0 2]) 1)", "(kurtosis (cols_py pp 2))", "(mode (cols_py pp 3))",
                "(mode (cols_py pp 2))", "(hist (cols_py pp 0))", '(hist (cols_py pp 1) "rice")',
                '(hist (cols_py pp 0) "fd")', '(hist (cols_py pp 2) "scott")',
                "(hist (cols_py pp 1) 7)", "(hist (cols_py pp 0) [-4 -1 0 2 9])",
                '(h2o.impute pp 0 "mean" "interpolate" [] _ _)',
                '(impute pp 1 "median" "interpolate" [3] _ _)',
                '(h2o.impute pp -1 "mode" "interpolate" [2 3] _ _)',
                '(impute pp -1 "mean" "interpolate" [7] _ _)', '(impute pp 3 "mode")',
                "(h2o.runif pp 42)", "(kfold_column pp 5 7)", "(kfold_column pp 3)",
                "(modulo_kfold_column pp 4)", "(stratified_kfold_column (cols_py pp 7) 3 11)",
                "(stratified_kfold_column (cols_py pp 2) 4)",
                "(h2o.random_stratified_split (cols_py pp 7) 0.25 5)",
                "(h2o.random_stratified_split (cols_py pp 2) 0.3 9)",
                "(h2o.random_stratified_split (cols_py pp 3) 0.5 1)",
                '(quantile (cols pp [0 1 2 4]) [0 0.1 0.25 0.5 0.99 1] "interpolate" _)',
                '(quantile (cols_py pp 3) [0.5 0.75] "low" _)', "(table (cols_py pp 3))",
                "(table (cols pp [3 7]))", "(table (cols_py pp 2) (cols_py pp 7))",
                "(table (cols_py pp 0))", "(unique (cols_py pp 3) 1)", "(unique (cols_py pp 3))",
                "(unique (cols_py pp 2) 1)", "(unique (cols_py pp 0) 0)",
                "(tf-idf tx 0 1 1 0)", "(tf-idf tx 0 1 0 1)", "(tf-idf tx 0 1)",
                "(rep_len (cols_py pp 3) 500)", "(rep_len 2.5 4)", "(seq 1 10 2)", "(seq 5 1 -1.5)",
                "(seq 0 1)", "(seq_len 5)", "(difflag1 (cols_py pp 0))", "(isax ts 4 8 0)",
                "(isax ts 3 4 0)", '(setproperty "H2O3_PRIM_PARITY_PROP" "on")',
                '(distance dr dq "l1")', '(distance dr dq "L2")', '(distance dr dq "cosine")',
                '(distance dr dq "cosine_sq")', '(distance dq dq "l2")'):
            jv, tv, pv, _ = s.run(expr)
            assert_same_val(jv, tv, expr)
            assert_same_val(pv, tv, expr)
        assert os.environ["H2O3_PRIM_PARITY_PROP"] == "on"
        # "," (the parser reads a comma as a separator): the last value
        for exprs in ([], ["1", "(cols_py pp 1)"]):
            assert_same_val(J_PRIMS[","](None, [j_exec(e, s.j) for e in exprs]),
                            T_PRIMS[","](None, [t_exec(e, s.t) for e in exprs]), exprs)
        # ls: each package's own store, sorted
        from h2o3_tpu.keyed import DKV as JDKV_
        from h2o3_tpu_torch.keyed import DKV as TDKV

        jv, tv, _, _ = s.run("(ls)")
        assert list(jv.value.col(0).data) == sorted(JDKV_.keys())
        assert list(tv.value.col(0).data) == sorted(TDKV.keys())
        assert {"pp", "dr", "tx"} <= set(tv.value.col(0).data)
        for expr in ('(cor (cols pp [0 1]) (cols pp [0 1]) "all.obs")',
                     '(impute pp 3 "mean")', '(impute pp 0 "mid")',
                     '(distance dr dq "manhattan")', '(distance dr (cols dq [0 1]) "l1")',
                     '(distance dr dn "l2")'):
            _same_error(s, expr)
    finally:
        os.environ.pop("H2O3_PRIM_PARITY_PROP", None)
        for key in ("dr", "dq", "dn", "tx", "ts"):
            s.j.remove(key)
            s.t.remove(key)
            s.keys.remove(key)


@contextlib.contextmanager
def _jax_keys_removed():
    from h2o3_tpu.keyed import DKV as JDKV_
    from h2o3_tpu.models.framework import Job as JJob

    before = set(JDKV_.keys())
    try:
        yield
    finally:
        for k in set(JDKV_.keys()) - before:
            if not isinstance(JDKV_.peek(k), JJob):
                JDKV_.remove(k)


def _assert_same_importances(jf, tf, ctx, atol=1e-6):
    """The same variables, each importance within ``atol``; the order only
    where neighbours part by more than ``atol`` (near-equal ones may swap)."""
    assert jf.names == tf.names, ctx
    jvars, tvars = list(jf.col(0).data), list(tf.col(0).data)
    assert set(jvars) == set(tvars) and len(jvars) == len(tvars), ctx
    for name in jf.names[1:]:
        jmap = dict(zip(jvars, jf.col(name).data))
        tmap = dict(zip(tvars, tf.col(name).data))
        for v in jvars:
            assert abs(jmap[v] - tmap[v]) <= atol, (ctx, name, v, jmap[v], tmap[v])
    key = dict(zip(jvars, jf.col(1).data))
    for a, b in zip(tvars, tvars[1:]):
        assert key[a] >= key[b] - atol, (ctx, tvars)


def _check_model_prims(s):
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.segments import SegmentModels as JSegmentModels
    from h2o3_tpu_torch.convert import glm_from_numpy
    from h2o3_tpu_torch.keyed import DKV as TDKV
    from h2o3_tpu_torch.models.segments import SegmentModels as TSegmentModels

    rng = np.random.default_rng(1)
    n = 400
    X = rng.normal(size=(n, 4))
    yv = (rng.random(n) < 1 / (1 + np.exp(-(X @ np.array([2.0, -1.0, 0.5, 0.0]))))).astype(
        np.int32)
    cols = [(f"x{j}", X[:, j], "NUM", None) for j in range(4)] + [
        ("y", yv, "CAT", ["0", "1"])]
    probs = np.round(rng.random(500), 2)  # ties
    acts = (rng.random(500) < probs).astype(np.float64)
    s.assign("pa", [("p", probs, "NUM", None), ("a", acts, "NUM", None)])
    s.assign("bad", [("p", np.array([0.1, 1.5]), "NUM", None),
                     ("a", np.array([0.0, 2.0]), "NUM", None)])
    with _jax_keys_removed():
        jfr, _ = s.assign("mf", cols)
        jm = JGLM(family="binomial", response_column="y").train(jfr)
        arrays = {"beta_std": jm.beta_std, "coefficients": jm.coefficients}
        pm = glm_from_numpy(arrays, dataclasses.asdict(jm.data_info),
                            dataclasses.asdict(jm.params), device="cpu")
        jsm, tsm = JSegmentModels(), TSegmentModels()
        for sm, model in ((jsm, jm), (tsm, pm)):
            sm.segments = [{"g": "a"}, {"g": "b"}, {"g": "c"}]
            sm.models = [model, None, model]
            sm.errors = [None, "ValueError: too few rows", None]
            sm.run_times = [0.1, 0.0, 0.1]
        try:
            for expr in ("(perfectAUC (cols_py pa 0) (cols_py pa 1))",
                         "(perfectAUC (cols_py pa 1) (cols_py pa 1))"):
                jv, tv, pv, _ = s.run(expr)
                assert_same_val(jv, tv, expr)
                assert_same_val(pv, tv, expr)
            for expr in ("(perfectAUC (cols_py bad 0) (cols_py pa 1))",
                         "(perfectAUC (cols_py pa 0) (cols_py bad 1))",
                         "(perfectAUC pa (cols_py pa 1))"):
                _same_error(s, expr)
            # the threshold: each model's own first, then the value set
            old = (jm.default_threshold(), pm.default_threshold())
            firsts = []
            for e, sess, m in ((j_exec, s.j, jm), (t_exec, s.t, pm)):
                firsts.append(e(f"(model.reset.threshold {m.key} 0.75)", sess))
                again = e(f'(model.reset.threshold "{m.key}" 0.25)', sess)
                assert m.default_threshold() == 0.25
                assert again.value.col(0).data[0] == 0.75
            assert [float(v.value.col(0).data[0]) for v in firsts] == list(old)
            assert_same_val(j_exec(f"(model.reset.threshold {jm.key} 0.5)", s.j),
                            t_exec(f"(model.reset.threshold {pm.key} 0.5)", s.t))
            assert _same_error(s, "(model.reset.threshold pa 0.5)",
                               message=False)[0] == "TypeError"
            # the segment models' frame, by id and by key string
            for jexpr, texpr in ((f"(segment_models_as_frame {jsm.key})",
                                  f"(segment_models_as_frame {tsm.key})"),
                                 (f'(segment_models_as_frame "{jsm.key}")',
                                  f'(segment_models_as_frame "{tsm.key}")')):
                jf, tf = j_exec(jexpr, s.j).value, t_exec(texpr, s.t).value
                assert tf.col("model").domain == [pm.key, ""]
                assert jf.col("model").domain == [jm.key, ""]
                tf.col("model").domain = jf.col("model").domain
                assert_same_frame(jf, tf, texpr)
            err = _same_error(s, f"(segment_models_as_frame {pm.key})",
                              f"(segment_models_as_frame {jm.key})", message=False)
            assert err[0] == "TypeError"
            # permutation importance: features empty, STRS and STR, the
            # sampled and repeated runs, every metric branch's errors
            for args in ('"auc" -1 1 [] 42', '"logloss" 200 2 ["x0" "x1"] 7',
                         '"auto" -1 1 "x2" 3', '"mse" 150 1 [] 5', '"AUTO" -1 3 [] 11'):
                jv = j_exec(f"(PermutationVarImp {jm.key} mf {args})", s.j)
                tv = t_exec(f"(PermutationVarImp {pm.key} mf {args})", s.t)
                _assert_same_importances(jv.value, tv.value, args)
            for args in ('"auc" 1 1 [] 42', '"auc" -1 1 ["zz"] 42', '"auc" -1 0 [] 42',
                         '"r2x" -1 1 [] 42', '"auc" -1 1 ["y"] 42', '"mae" 500 1 [] 1'):
                _same_error(s, f"(PermutationVarImp {pm.key} mf {args})",
                            f"(PermutationVarImp {jm.key} mf {args})")
        finally:
            for key in ("mf", "pa", "bad"):
                s.j.remove(key)
                s.t.remove(key)
                s.keys.remove(key)
            TDKV.remove(pm.key)
            TDKV.remove(tsm.key)


def test_string_time_math_search_and_model_prims_match_jax(tmp_path):
    """Every prim of ``strings``, ``times``, ``advmath``, ``models`` and
    ``search``: the port's CPU session (fused and interpreted) bit for bit
    against the JAX package, errors alike; ``PermutationVarImp`` per
    variable at 1e-6."""
    s = Sessions()
    try:
        s.assign("pp", _prim_columns(300, 21))
        _check_search_and_strings(s, tmp_path)
        _check_times(s)
        _check_advmath(s)
        _check_model_prims(s)
    finally:
        s.close()


def test_compute_core_matches_jax(monkeypatch):
    rng = np.random.default_rng(7)
    n = 10_001
    cols = [("x", rng.normal(size=n), "NUM", None), ("y", rng.normal(2.0, size=n), "NUM", None)]
    jf, tf = both(cols)
    # -- map_reduce (sum, max, min) and map_batches on the resident table
    jt = j_mr.FrameTable.from_frame(jf)
    tt = t_mr.FrameTable.from_frame(tf, device="cpu")
    assert t_mr.FrameTable.from_frame(tf, device="cpu") is tt  # a frame_table hit
    assert tt.n_padded == tt.n_valid == n and bool(tt.mask.all())

    def j_stats(c, m):
        ok = m & ~jnp.isnan(c["x"])
        return {"n": jnp.sum(ok), "sum": jnp.sum(jnp.where(ok, c["x"], 0.0))}

    def t_stats(c, m):
        ok = m & ~torch.isnan(c["x"])
        return {"n": ok.sum(), "sum": torch.where(ok, c["x"], 0.0).sum()}

    jo, to = j_mr.map_reduce(j_stats, jt), t_mr.map_reduce(t_stats, tt)
    assert int(jo["n"]) == int(to["n"]) == n
    np.testing.assert_allclose(float(to["sum"]), float(jo["sum"]), rtol=1e-5)
    for red, jfn, tfn in (("max", jnp.max, torch.max), ("min", jnp.min, torch.min)):
        fill = -np.inf if red == "max" else np.inf
        jv = j_mr.map_reduce(lambda c, m: jfn(jnp.where(m, c["y"], fill)), jt, reduce=red)
        tv = t_mr.map_reduce(lambda c, m: tfn(torch.where(m, c["y"], fill)), tt, reduce=red)
        assert float(jv) == float(tv)
    for mod, table in ((j_mr, jt), (t_mr, tt)):
        with pytest.raises(ValueError, match="unknown reduce 'mean'"):
            mod.map_reduce(lambda c, m: 0, table, reduce="mean")
    jb = j_mr.gather_rows(j_mr.map_batches(lambda c, m: c["x"] * 2.0 + c["y"], jt), n)
    tb = t_mr.gather_rows(t_mr.map_batches(lambda c, m: c["x"] * 2.0 + c["y"], tt), n)
    assert bits_equal(jb, tb)
    assert tuple(tt.matrix(["x", "y"]).shape) == (n, 2) and tt.matrix(["x", "y"]) is \
        tt.matrix(["x", "y"])
    out = t_mr.map_reduce_frame(t_stats, tf, columns=["x"], device="cpu")
    assert int(out["n"]) == n and isinstance(out["sum"], np.ndarray)
    tf.col("x").invalidate_rollups()  # a mutation: a new placement
    assert t_mr.FrameTable.from_frame(tf, device="cpu") is not tt
    # -- quantiles bit for bit: float32 as the JAX package runs, float64
    # under its 64-bit mode, NaNs, an outlier-dominated range, ties
    probs = [0.0, 0.001, 0.01, 0.25, 0.5, 0.75, 0.99, 0.999, 1.0]
    xs = [rng.normal(size=50_000).astype(np.float32),
          np.concatenate([np.arange(1000, dtype=np.float32), [np.float32(1e30)]]),
          np.where(rng.random(20_000) < 0.1, np.nan, rng.standard_cauchy(20_000)).astype(
              np.float32),
          rng.integers(0, 5, 3000).astype(np.float32), np.full(10, np.nan, np.float32)]
    for x in xs:
        assert bits_equal(j_q.quantiles(x, probs), t_q.quantiles(x, probs, device="cpu"))
    x64 = np.where(rng.random(20_000) < 0.1, np.nan, rng.standard_cauchy(20_000))
    with jax.experimental.enable_x64():
        want = j_q.quantiles(x64, probs)
    assert bits_equal(want, t_q.quantiles(torch.from_numpy(x64), probs))
    # -- the mergeable sketches
    for col, nb in ((rng.normal(size=5000), 16), (rng.integers(0, 6, 900).astype(float), 8),
                    (np.full(20, np.nan), 4)):
        jp, tp = j_q.sketch_column(col, nb), t_q.sketch_column(col, nb)
        assert jp.keys() == tp.keys() and all(bits_equal(jp[k], tp[k]) for k in jp)
    parts = [t_q.sketch_column(rng.normal(size=700) + i, 16) for i in range(3)]
    low = [t_q.sketch_column(rng.integers(0, 4, 50).astype(float), 8) for _ in range(2)]
    for ps, nb in ((parts, 16), (low, 8), ([{"n": 0}], 5)):
        assert bits_equal(j_q.merge_edges(ps, nb), t_q.merge_edges(ps, nb))
    # -- rollups of NUM, CAT, TIME and STR columns, the histogram and the
    # codec moment helpers
    num = rng.normal(size=500)
    num[::9] = np.nan
    num[::11] = 0.0
    jr, tr = both([("n", num, "NUM", None),
                   ("c", rng.integers(-1, 4, 500).astype(np.int32), "CAT", list("wxyz")),
                   ("t", 1.6e12 + rng.integers(0, 99, 500) * 1000.0, "TIME", None),
                   ("s", np.array(["a", None] * 250, dtype=object), "STR", None),
                   ("e", np.full(500, np.nan), "NUM", None)])
    for jc, tc in zip(jr.columns, tr.columns):
        a, b = jc.rollups, tc.rollups
        for f in ("min", "max", "mean", "sigma", "na_count", "zero_count", "is_int",
                  "checksum"):
            assert bits_equal(getattr(a, f), getattr(b, f)), (jc.name, f)
        if jc.type is not j_frame.ColType.STR:
            assert np.array_equal(j_roll.histogram(jc, 16), t_roll.histogram(tc, 16))
    vals, counts = np.array([0.0, 1.5, np.nan, 3.0]), np.array([4, 0, 2, 7])
    assert j_roll._weighted_moments(vals, counts) == t_roll._weighted_moments(vals, counts)
    assert bits_equal(j_roll._dense_moments(num), t_roll._dense_moments(num))
    # -- x above a lowered device threshold (float32 on both devices), t
    monkeypatch.setattr(j_matrix, "_DEVICE_MIN_ELEMS", 64)
    monkeypatch.setattr(t_matrix, "_DEVICE_MIN_ELEMS", 64)
    s = Sessions()
    try:
        s.assign("a", [(f"c{j}", rng.normal(size=301), "NUM", None) for j in range(6)])
        s.assign("b", [(f"d{j}", rng.normal(size=6), "NUM", None) for j in range(3)])
        jv, tv, pv, _ = s.run("(x a b)")
        assert tv.value.names == jv.value.names
        np.testing.assert_allclose(tv.value.to_numpy(), jv.value.to_numpy(), rtol=1e-5,
                                   atol=1e-6)
        hits = t_devcache.DEVCACHE.stats()["kinds"]["mmult_lhs"]["hits"]
        t_exec("(x a b)", s.t)
        assert t_devcache.DEVCACHE.stats()["kinds"]["mmult_lhs"]["hits"] == hits + 1
        jv, tv, _, _ = s.run("(t a)")
        assert_same_val(jv, tv)
    finally:
        s.close()
