"""POJO-style standalone scoring source — the port of
``h2o3_tpu/models/pojo.py``.

Reference: ``hex/tree/TreeJCodeGen.java`` + ``water/codegen/``: a trained
model as dependency-free scoring source that runs without the cluster.

  * C: compiles with any C99 compiler and needs no runtime; the tests
    compile it with the host's gcc and hold it to the model's predictions.
  * Java: the same trees as one class with a ``score0(double[] row,
    double[] preds)`` in the genmodel shape.

A tree scorer takes the model's tree-feature vector (``tree_feature_names``
order: label-encoded category codes, or the one-hot block under
``one_hot_explicit``) as ``float`` values: training binned float32
features, so scoring in float keeps each threshold comparison the one the
device path makes.

A GLM scorer (``glm_pojo_c``, ``glm_multinomial_pojo_c``; C only) takes
the model's standardized design vector (``expand_matrix`` order) as
``double`` values and applies the standardized betas and the link; the
ordinal family is refused, as in the JAX package. A GAM scorer
(``gam_pojo_c``; C only, cubic-regression smoothers only) takes the linear
design vector followed by the raw value of each gam column and rebuilds
each smoother's basis.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _c_float(v: float) -> str:
    if np.isnan(v):
        return "NAN"
    if np.isinf(v):
        return "INFINITY" if v > 0 else "-INFINITY"
    return repr(float(v))


def _c_arr(name: str, vals, ctype: str, fmt=str) -> str:
    body = ", ".join(fmt(v) for v in vals)
    return f"static const {ctype} {name}[] = {{{body}}};\n"


# ---------------------------------------------------------------------------
# tree models (GBM / DRF / XGBoost-style)


def _tree_tables(model):
    """Flatten the booster into per-class per-tree node tables with raw
    float thresholds (bin edge at the split bin; +inf when the split only
    separates NA from non-NA)."""
    b = model.booster
    out = []
    for trees in b.trees_per_class:
        edges = trees.edges  # [F, B-1]
        cls_trees = []
        for t in range(trees.ntrees):
            feat = trees.feat[t].astype(np.int32)
            sb = trees.split_bin[t].astype(np.int64)
            # thresholds stay float64: the framework compares float32
            # features against float64 edges, and rounding the edge to
            # f32 would flip rows landing exactly on the rounded value
            thr = np.where(
                sb >= edges.shape[1],
                np.inf,
                edges[feat, np.clip(sb, 0, edges.shape[1] - 1)],
            ).astype(np.float64)
            cls_trees.append({
                "feat": feat,
                "thr": thr,
                "default_left": trees.default_left[t].astype(np.int32),
                "is_split": trees.is_split[t].astype(np.int32),
                "leaf": trees.leaf[t].astype(np.float64),
            })
        out.append(cls_trees)
    return out


def tree_pojo_c(model) -> str:
    from h2o3_tpu_torch.models.tree.common import tree_feature_names

    b = model.booster
    names = tree_feature_names(model.data_info, model.tree_encoding)
    tables = _tree_tables(model)
    K = len(tables)
    T = len(tables[0])
    M = tables[0][0]["feat"].shape[0]
    depth = int(np.log2(M + 1)) - 1
    dist = model.distribution
    nclasses = model.nclasses

    chunks: List[str] = []
    chunks.append(
        f"""/* GENERATED standalone scorer — do not edit.
 * Model: {model.key} ({model.algo_name}, distribution={dist})
 * Emitted by h2o3_tpu_torch.models.pojo (TreeJCodeGen/water-codegen analogue).
 *
 * double out[{max(nclasses, 1) + (1 if nclasses > 1 else 0)}];
 * score(x, out);
 *   x: float[{len(names)}] tree features, order: {", ".join(names)}
 *      (categorical columns: label-encoded level index; NAN = missing)
 *   classifier out: [predicted_class, p0, p1, ...]; regression out: [mu]
 */
#include <math.h>

#define N_FEAT {len(names)}
#define N_CLASS_SETS {K}
#define N_TREES {T}
#define N_NODES {M}
#define MAX_DEPTH {depth}

""")
    for c, cls_trees in enumerate(tables):
        for t, tb in enumerate(cls_trees):
            p = f"c{c}_t{t}"
            chunks.append(_c_arr(f"feat_{p}", tb["feat"], "int"))
            chunks.append(_c_arr(f"thr_{p}", tb["thr"], "double", _c_float))
            chunks.append(_c_arr(f"dl_{p}", tb["default_left"], "int"))
            chunks.append(_c_arr(f"sp_{p}", tb["is_split"], "int"))
            chunks.append(_c_arr(f"leaf_{p}", tb["leaf"], "double", _c_float))
    chunks.append(_c_arr("init_margin", np.asarray(b.init_margin, np.float64),
                         "double", _c_float))
    chunks.append("""
static double walk(const float *x, const int *feat, const double *thr,
                   const int *dl, const int *sp, const double *leaf) {
  int idx = 0;
  for (int d = 0; d < MAX_DEPTH; d++) {
    if (!sp[idx]) break;
    double v = (double)x[feat[idx]];  /* f32 feature vs f64 edge, as trained */
    int left = isnan(v) ? dl[idx] : (v < thr[idx]);
    idx = 2 * idx + (left ? 1 : 2);
  }
  return leaf[idx];
}

""")
    # per-class margin accumulators
    chunks.append("static double margin_class(const float *x, int c) {\n"
                  "  double s = 0.0;\n  switch (c) {\n")
    for c, cls_trees in enumerate(tables):
        chunks.append(f"  case {c}:\n")
        for t in range(len(cls_trees)):
            p = f"c{c}_t{t}"
            chunks.append(
                f"    s += walk(x, feat_{p}, thr_{p}, dl_{p}, sp_{p}, "
                f"leaf_{p});\n")
        chunks.append("    break;\n")
    chunks.append("  }\n")
    if getattr(b, "average", False):
        chunks.append("  s /= (double)N_TREES;\n")
    chunks.append("  return init_margin[c] + s;\n}\n\n")

    averaged = bool(getattr(b, "average", False))
    if averaged and nclasses == 2:
        # DRF: the single tree set predicts P(class 1) directly
        chunks.append("""void score(const float *x, double *out) {
  double p1 = margin_class(x, 0);
  if (p1 < 0.0) p1 = 0.0;
  if (p1 > 1.0) p1 = 1.0;
  out[1] = 1.0 - p1; out[2] = p1;
  out[0] = (p1 >= 0.5) ? 1.0 : 0.0;  /* threshold tuned server-side */
}
""")
    elif averaged and nclasses > 2:
        chunks.append("""void score(const float *x, double *out) {
  double s = 0.0;
  int best = 0;
  for (int c = 0; c < N_CLASS_SETS; c++) {
    double p = margin_class(x, c);
    if (p < 1e-9) p = 1e-9;
    out[1 + c] = p; s += p;
  }
  for (int c = 0; c < N_CLASS_SETS; c++) {
    out[1 + c] /= s;
    if (out[1 + c] > out[1 + best]) best = c;
  }
  out[0] = (double)best;
}
""")
    elif nclasses == 2 and dist == "bernoulli":
        chunks.append("""void score(const float *x, double *out) {
  double m = margin_class(x, 0);
  double p1 = 1.0 / (1.0 + exp(-m));
  out[1] = 1.0 - p1; out[2] = p1;
  out[0] = (p1 >= 0.5) ? 1.0 : 0.0;  /* threshold tuned server-side */
}
""")
    elif nclasses > 2:
        chunks.append("""void score(const float *x, double *out) {
  double m[N_CLASS_SETS], mx = -INFINITY, s = 0.0;
  for (int c = 0; c < N_CLASS_SETS; c++) {
    m[c] = margin_class(x, c);
    if (m[c] > mx) mx = m[c];
  }
  for (int c = 0; c < N_CLASS_SETS; c++) { m[c] = exp(m[c] - mx); s += m[c]; }
  int best = 0;
  for (int c = 0; c < N_CLASS_SETS; c++) {
    out[1 + c] = m[c] / s;
    if (out[1 + c] > out[1 + best]) best = c;
  }
  out[0] = (double)best;
}
""")
    else:
        link = ("exp(m)" if dist.partition(":")[0] in
                ("poisson", "gamma", "tweedie") else "m")
        chunks.append(f"""void score(const float *x, double *out) {{
  double m = margin_class(x, 0);
  out[0] = {link};
}}
""")
    return "".join(chunks)


def tree_pojo_java(model) -> str:
    """Reference-shaped Java source: one class, score0(double[], double[])."""
    from h2o3_tpu_torch.models.tree.common import tree_feature_names

    b = model.booster
    names = tree_feature_names(model.data_info, model.tree_encoding)
    tables = _tree_tables(model)
    dist = model.distribution
    nclasses = model.nclasses
    cls_name = f"POJO_{model.key}".replace("-", "_").replace(".", "_")

    def jarr(vals, jt, fmt):
        return "{" + ", ".join(fmt(v) for v in vals) + "}"

    def jdouble(v):
        if np.isnan(v):
            return "Double.NaN"
        if np.isinf(v):
            return ("Double.POSITIVE_INFINITY" if v > 0
                    else "Double.NEGATIVE_INFINITY")
        return repr(float(v))

    out = [f"""// GENERATED standalone scorer — do not edit.
// Model: {model.key} ({model.algo_name}); features: {", ".join(names)}
public class {cls_name} {{
"""]
    for c, cls_trees in enumerate(tables):
        for t, tb in enumerate(cls_trees):
            p = f"c{c}_t{t}"
            out.append(f"  static final int[] FEAT_{p} = "
                       f"{jarr(tb['feat'], 'int', str)};\n")
            out.append(f"  static final double[] THR_{p} = "
                       f"{jarr(tb['thr'], 'double', jdouble)};\n")
            out.append(f"  static final boolean[] DL_{p} = "
                       f"{jarr(tb['default_left'], 'boolean', lambda v: 'true' if v else 'false')};\n")
            out.append(f"  static final boolean[] SP_{p} = "
                       f"{jarr(tb['is_split'], 'boolean', lambda v: 'true' if v else 'false')};\n")
            out.append(f"  static final double[] LEAF_{p} = "
                       f"{jarr(tb['leaf'], 'double', jdouble)};\n")
    out.append(f"  static final double[] INIT = "
               f"{jarr(np.asarray(b.init_margin, np.float64), 'double', jdouble)};\n")
    M = tables[0][0]["feat"].shape[0]
    depth = int(np.log2(M + 1)) - 1
    out.append(f"""
  static double walk(float[] x, int[] feat, double[] thr, boolean[] dl,
                     boolean[] sp, double[] leaf) {{
    int idx = 0;
    for (int d = 0; d < {depth}; d++) {{
      if (!sp[idx]) break;
      double v = (double) x[feat[idx]];  // f32 feature vs f64 edge
      boolean left = Double.isNaN(v) ? dl[idx] : (v < thr[idx]);
      idx = 2 * idx + (left ? 1 : 2);
    }}
    return leaf[idx];
  }}

  static double marginClass(float[] x, int c) {{
    double s = 0.0;
    switch (c) {{
""")
    for c, cls_trees in enumerate(tables):
        out.append(f"      case {c}:\n")
        for t in range(len(cls_trees)):
            p = f"c{c}_t{t}"
            out.append(f"        s += walk(x, FEAT_{p}, THR_{p}, DL_{p}, "
                       f"SP_{p}, LEAF_{p});\n")
        out.append("        break;\n")
    out.append("    }\n")
    if getattr(b, "average", False):
        out.append(f"    s /= {len(tables[0])}.0;\n")
    out.append("    return INIT[c] + s;\n  }\n")
    averaged = bool(getattr(b, "average", False))
    if averaged and nclasses == 2:
        out.append("""
  public static double[] score0(double[] row, double[] preds) {
    float[] x = new float[row.length];
    for (int i = 0; i < row.length; i++) x[i] = (float) row[i];
    double p1 = marginClass(x, 0);
    p1 = Math.min(1.0, Math.max(0.0, p1));
    preds[1] = 1.0 - p1; preds[2] = p1; preds[0] = p1 >= 0.5 ? 1 : 0;
    return preds;
  }
}
""")
    elif averaged and nclasses > 2:
        K = len(tables)
        out.append(f"""
  public static double[] score0(double[] row, double[] preds) {{
    float[] x = new float[row.length];
    for (int i = 0; i < row.length; i++) x[i] = (float) row[i];
    double s = 0.0;
    int best = 0;
    for (int c = 0; c < {K}; c++) {{
      double p = Math.max(1e-9, marginClass(x, c));
      preds[1 + c] = p; s += p;
    }}
    for (int c = 0; c < {K}; c++) {{
      preds[1 + c] /= s;
      if (preds[1 + c] > preds[1 + best]) best = c;
    }}
    preds[0] = best;
    return preds;
  }}
}}
""")
    elif nclasses == 2 and dist == "bernoulli":
        out.append("""
  public static double[] score0(double[] row, double[] preds) {
    float[] x = new float[row.length];
    for (int i = 0; i < row.length; i++) x[i] = (float) row[i];
    double p1 = 1.0 / (1.0 + Math.exp(-marginClass(x, 0)));
    preds[1] = 1.0 - p1; preds[2] = p1; preds[0] = p1 >= 0.5 ? 1 : 0;
    return preds;
  }
}
""")
    elif nclasses > 2:
        K = len(tables)
        out.append(f"""
  public static double[] score0(double[] row, double[] preds) {{
    float[] x = new float[row.length];
    for (int i = 0; i < row.length; i++) x[i] = (float) row[i];
    double[] m = new double[{K}];
    double mx = Double.NEGATIVE_INFINITY, s = 0.0;
    for (int c = 0; c < {K}; c++) {{ m[c] = marginClass(x, c); if (m[c] > mx) mx = m[c]; }}
    for (int c = 0; c < {K}; c++) {{ m[c] = Math.exp(m[c] - mx); s += m[c]; }}
    int best = 0;
    for (int c = 0; c < {K}; c++) {{
      preds[1 + c] = m[c] / s;
      if (preds[1 + c] > preds[1 + best]) best = c;
    }}
    preds[0] = best;
    return preds;
  }}
}}
""")
    else:
        expo = dist.partition(":")[0] in ("poisson", "gamma", "tweedie")
        expr = "Math.exp(m)" if expo else "m"
        out.append(f"""
  public static double[] score0(double[] row, double[] preds) {{
    float[] x = new float[row.length];
    for (int i = 0; i < row.length; i++) x[i] = (float) row[i];
    double m = marginClass(x, 0);
    preds[0] = {expr};
    return preds;
  }}
}}
""")
    return "".join(out)


# ---------------------------------------------------------------------------
# GLM


def glm_pojo_c(model) -> str:
    """Linear scorer over the model's design vector.

    The design vector is exactly what ``expand_matrix`` produces at
    predict time (NA-imputed, one-hot expanded, standardized numerics),
    scored with the standardized betas — so the emitted source computes
    the same eta bit-for-bit as the in-framework ``_eta``."""
    names = list(model.data_info.coef_names)
    beta_full = np.asarray(model.beta_std, dtype=np.float64)
    beta, icpt = beta_full[:-1], float(beta_full[-1])
    family = model.params.family
    nclasses = model.nclasses
    chunks = [f"""/* GENERATED standalone GLM scorer — do not edit.
 * Model: {model.key} (family={family})
 * x: double[{len(names)}] standardized design vector (expand_matrix
 * order: numerics (v - train_mean) / train_sd, NA mean-imputed,
 * categoricals one-hot): {", ".join(names)}
 */
#include <math.h>

"""]
    chunks.append(_c_arr("beta", beta, "double", _c_float))
    chunks.append(f"static const double intercept = {_c_float(icpt)};\n\n")
    # exact _linkinv replication per resolved link (glm._linkinv) — used
    # for BOTH branches: a binomial model with a non-canonical link must
    # score through its actual link, not a hardcoded sigmoid
    link = model.params.actual_link()
    if link == "identity":
        inv = "mu = eta;"
    elif link == "log":
        inv = "mu = exp(eta);"
    elif link == "inverse":
        inv = ("{ double d = eta; if (fabs(d) < 1e-10) "
               "d = (d + 1e-30 >= 0.0 ? 1e-10 : -1e-10); mu = 1.0 / d; }")
    elif link == "tweedie":
        lp = float(model.params.tweedie_link_power)
        inv = ("mu = exp(eta);" if lp == 0 else
               f"mu = pow(eta > 1e-10 ? eta : 1e-10, {1.0 / lp!r});")
    elif link == "logit":
        inv = "mu = 1.0 / (1.0 + exp(-eta));"
    else:
        raise ValueError(f"unsupported link {link!r} for POJO export")
    if nclasses == 2:
        chunks.append(f"""void score(const double *x, double *out) {{
  double eta = intercept;
  for (int i = 0; i < {len(beta)}; i++) eta += beta[i] * x[i];
  double mu;
  {inv}
  out[1] = 1.0 - mu; out[2] = mu; out[0] = (mu >= 0.5) ? 1.0 : 0.0;
}}
""")
    else:
        chunks.append(f"""void score(const double *x, double *out) {{
  double eta = intercept;
  for (int i = 0; i < {len(beta)}; i++) eta += beta[i] * x[i];
  double mu;
  {inv}
  out[0] = mu;
}}
""")
    return "".join(chunks)


def glm_multinomial_pojo_c(model) -> str:
    """Multinomial GLM scorer: K etas over the standardized design
    vector (class-major beta_multi layout, intercept row last) +
    numerically-stable softmax — matching ``_predict_raw``'s
    ``_softmax(X @ B[:-1] + B[-1])`` exactly."""
    names = list(model.data_info.coef_names)
    B = np.asarray(model.beta_multi, dtype=np.float64)  # [P+1, K]
    P, K = B.shape[0] - 1, B.shape[1]
    chunks = [f"""/* GENERATED standalone multinomial GLM scorer — do not edit.
 * Model: {model.key} (K={K} classes)
 * x: double[{P}] standardized design vector (expand_matrix order):
 * {", ".join(names)}
 * out: [label, p_0..p_{K - 1}]
 */
#include <math.h>

"""]
    chunks.append(_c_arr("beta", B[:-1].ravel(), "double", _c_float))
    chunks.append(_c_arr("icpt", B[-1], "double", _c_float))
    chunks.append(f"""
void score(const double *x, double *out) {{
  double eta[{K}];
  double mx = -1e308;
  for (int k = 0; k < {K}; k++) {{
    double e = icpt[k];
    for (int i = 0; i < {P}; i++) e += beta[i * {K} + k] * x[i];
    eta[k] = e;
    if (e > mx) mx = e;
  }}
  double tot = 0.0;
  for (int k = 0; k < {K}; k++) {{ eta[k] = exp(eta[k] - mx); tot += eta[k]; }}
  int best = 0;
  for (int k = 0; k < {K}; k++) {{
    out[k + 1] = eta[k] / tot;
    if (out[k + 1] > out[best + 1]) best = k;
  }}
  out[0] = (double) best;
}}
""")
    return "".join(chunks)


def gam_pojo_c(model) -> str:
    """Standalone GAM scorer: the emitted source re-computes each
    cubic-regression smoother's basis (cr_basis algebra: locateBin +
    a/c functions + the B⁻¹D rows), centers it through Z, and adds the
    linear eta — matching in-framework ``_predict_raw`` exactly for
    rows inside the knot range (outside, the C clamps to the boundary
    knot while training-side scoring extrapolates linearly; NA gam
    values mean-impute with the training median like ``GamSpec.expand``).

    Input contract: ``x = [linear design vector (expand_matrix order,
    len n_lin)] + [raw gam column values, one per smoother]``."""
    from h2o3_tpu_torch.models.gam import cr_matrices

    if any(s.kind != 0 for s in model.specs):
        raise ValueError("GAM POJO export covers cubic-regression "
                         "smoothers (bs=0) only")
    p = model.params
    if p.family in ("multinomial", "ordinal"):
        raise ValueError("GAM POJO export supports single-eta families "
                         "only")
    info = model.data_info
    n_lin = len(info.coef_names)
    beta_full = np.asarray(model.beta, dtype=np.float64)
    beta, icpt = beta_full[:-1], float(beta_full[-1])
    link = p.actual_link()
    if link == "identity":
        inv = "mu = eta;"
    elif link == "log":
        inv = "mu = exp(eta);"
    elif link == "logit":
        inv = "mu = 1.0 / (1.0 + exp(-eta));"
    else:
        raise ValueError(f"unsupported link {link!r} for GAM POJO export")

    chunks = [f"""/* GENERATED standalone GAM scorer — do not edit.
 * Model: {model.key} (family={p.family})
 * x: double[{n_lin + len(model.specs)}] = linear design vector
 * ({", ".join(info.coef_names)}) then raw gam values
 * ({", ".join(s.column for s in model.specs)})
 */
#include <math.h>

"""]
    chunks.append(_c_arr("beta", beta, "double", _c_float))
    chunks.append(f"static const double intercept = {_c_float(icpt)};\n")
    for ci, s in enumerate(model.specs):
        K = len(s.knots)
        D, B = cr_matrices(np.asarray(s.knots))
        binvd = np.linalg.solve(B, D)
        chunks.append(_c_arr(f"knots_{ci}", s.knots, "double", _c_float))
        chunks.append(_c_arr(f"binvd_{ci}", binvd.ravel(), "double",
                             _c_float))
        chunks.append(_c_arr(f"zt_{ci}", np.ascontiguousarray(
            s.Z.T).ravel(), "double", _c_float))
        chunks.append(
            f"static const double nafill_{ci} = "
            f"{_c_float(s.na_fill)};\n")
        chunks.append(f"""
static void gamify_{ci}(double xv, double *out) {{
  const int K = {K};
  double basis[{K}];
  if (isnan(xv)) xv = nafill_{ci};
  if (xv < knots_{ci}[0]) xv = knots_{ci}[0];
  if (xv > knots_{ci}[K-1]) xv = knots_{ci}[K-1];
  int j = 0;
  while (j < K - 2 && xv >= knots_{ci}[j+1]) j++;
  double hj = knots_{ci}[j+1] - knots_{ci}[j];
  double tm = knots_{ci}[j+1] - xv, tp = xv - knots_{ci}[j];
  double cmj = (tm*tm*tm/hj - tm*hj) / 6.0;
  double cpj = (tp*tp*tp/hj - tp*hj) / 6.0;
  for (int i = 0; i < K; i++) {{
    double v = 0.0;
    if (j > 0) v += binvd_{ci}[(j-1)*K + i] * cmj;
    if (j < K - 2) v += binvd_{ci}[j*K + i] * cpj;
    basis[i] = v;
  }}
  basis[j] += tm / hj;
  basis[j+1] += tp / hj;
  for (int r = 0; r < K - 1; r++) {{
    double acc = 0.0;
    for (int i = 0; i < K; i++) acc += zt_{ci}[r*K + i] * basis[i];
    out[r] = acc;
  }}
}}
""")
    body = [f"""
void score(const double *x, double *out) {{
  double eta = intercept;
  for (int i = 0; i < {n_lin}; i++) eta += beta[i] * x[i];
"""]
    off = n_lin
    for ci, s in enumerate(model.specs):
        kz = len(s.knots) - 1
        body.append(f"""  {{
    double g[{kz}];
    gamify_{ci}(x[{n_lin + ci}], g);
    for (int r = 0; r < {kz}; r++) eta += beta[{off} + r] * g[r];
  }}
""")
        off += kz
    body.append(f"""  double mu;
  {inv}
""")
    if model.nclasses == 2:
        body.append("  out[1] = 1.0 - mu; out[2] = mu; "
                    "out[0] = (mu >= 0.5) ? 1.0 : 0.0;\n}\n")
    else:
        body.append("  out[0] = mu;\n}\n")
    chunks.extend(body)
    return "".join(chunks)


def pojo_source(model, lang: str = "c") -> str:
    from h2o3_tpu_torch.models.tree.common import TreeModelBase

    if getattr(model.params, "offset_column", None):
        # predict adds the scoring frame's offset to the margin; an exported
        # scorer has no offset input, and refusing beats dropping the term
        raise ValueError(
            "POJO export does not support offset_column models")
    if isinstance(model, TreeModelBase):
        if model.booster is None:
            raise ValueError("model has no trained trees")
        return tree_pojo_c(model) if lang == "c" else tree_pojo_java(model)
    if getattr(model, "algo_name", "") == "gam":
        if lang != "c":
            raise ValueError("GAM POJO is emitted as C only")
        return gam_pojo_c(model)
    if hasattr(model, "coefficients") and isinstance(
            getattr(model, "coefficients", None), dict):
        if lang != "c":
            raise ValueError("GLM POJO is emitted as C only")
        if getattr(model.params, "family", "") == "multinomial":
            if getattr(model, "beta_multi", None) is None:
                raise ValueError("multinomial GLM has no trained betas")
            return glm_multinomial_pojo_c(model)
        if getattr(model.params, "family", "") == "ordinal" \
                or getattr(model, "beta_std", None) is None:
            raise ValueError(
                "GLM POJO export does not cover the ordinal family "
                "(thresholded cumulative etas)")
        return glm_pojo_c(model)
    raise ValueError(
        f"POJO export supports tree models and GLM, not {model.algo_name}")
