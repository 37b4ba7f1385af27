"""Reference-format MOJO export — the port of ``h2o3_tpu/models/mojo_ref.py``:
the actual H2O-3 MOJO zip layout.

Reference (format spec, mirrored byte-for-byte):
  * container: ``hex/ModelMojoWriter.java`` — a zip of ``model.ini``
    ([info] key=value, [columns], [domains] sections), ``domains/d*.txt``
    and binary blobs;
  * compressed trees: ``hex/tree/DTree.java:727-815`` (``size``/
    ``compress``) — per decided node: 1B nodeType (equal bits 8/12,
    left-leaf |=48, else skip-size bits; right-leaf |=0xC0), 2B colId,
    1B naSplitDir, 4B float split value, skip offset in 1..4 bytes,
    then the left and right subtrees inline; leaves are a bare 4B
    float; a root-leaf is ``00 FF FF`` + float
    (``DTree.java:855``);
  * reader contract: ``hex/genmodel/ModelMojoReader.readAll`` (required
    [info] keys), ``SharedTreeMojoReader`` (n_trees/n_trees_per_class/
    tree blob names), ``GbmMojoModel.score0/unifyPreds`` (init_f +
    link inverse; multinomial softmax over per-class tree sums).

The writer emits GBM models in this exact layout; ``read_mojo`` is an
INDEPENDENT decoder implementing the ``SharedTreeMojoModel.scoreTree``
byte-walk, used by the parity tests (write -> decode -> score must
equal in-framework predict). It handles float splits only; bitset
categorical splits are rejected loudly — this framework's boosters
label-encode categoricals, so the writer never emits them.

The writers read only host numpy arrays that the models keep (tree
arrays, coefficients, centers, eigenvectors, vectors, smoother specs), and
run on the host as in the JAX package: given the same model arrays, every
archive member is the JAX package's bytes but for the fresh ``uuid`` in
``model.ini``, and each package's ``read_mojo`` decodes the other's
archives.
"""

from __future__ import annotations

import io
import struct
import uuid as _uuid
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_NA_LEFT = 2
_NA_RIGHT = 3

_LINK_BY_DIST = {
    "bernoulli": "logit",
    "multinomial": "identity",  # softmax applied in unifyPreds
    "poisson": "log",
    "gamma": "log",
    "tweedie": "log",
}


# ---------------------------------------------------------------------------
# tree encoder (DTree.size + DTree.compress)


def _encode_subtree(trees, t: int, i: int, edges, raw_thresh=None) -> bytes:
    """Compress the heap subtree rooted at node i of tree t.

    raw_thresh: optional [M] float thresholds for trees that split on raw
    values rather than bin codes (isolation forest) — bypasses the
    edges[feature][bin] lookup."""
    is_split = trees.is_split[t]
    if not is_split[i]:
        return struct.pack("<f", float(trees.leaf[t][i]))
    f = int(trees.feat[t][i])
    if raw_thresh is not None:
        thr = float(raw_thresh[i])
    else:
        sb = int(trees.split_bin[t][i])
        thr = (np.inf if sb >= edges.shape[1]
               else float(edges[f][sb]))
    # a split node's children always exist in the heap (splits stop one
    # level above the leaf frontier)
    left = _encode_subtree(trees, t, 2 * i + 1, edges, raw_thresh)
    right = _encode_subtree(trees, t, 2 * i + 2, edges, raw_thresh)
    left_leaf = not is_split[2 * i + 1]
    right_leaf = not is_split[2 * i + 2]

    node_type = 0  # equal == 0: float compare
    if left_leaf:
        node_type |= 48
        offset = b""
    else:
        lsz = len(left)
        slen = 0 if lsz < 256 else (1 if lsz < 65535 else
                                    (2 if lsz < (1 << 24) else 3))
        node_type |= slen
        offset = lsz.to_bytes(slen + 1, "little")
    if right_leaf:
        node_type |= (48 << 2) & 0xFF

    na_dir = _NA_LEFT if trees.default_left[t][i] else _NA_RIGHT
    out = bytearray()
    out.append(node_type)
    out += struct.pack("<H", f)
    out.append(na_dir)
    out += struct.pack("<f", thr)
    out += offset
    out += left
    out += right
    return bytes(out)


def _encode_tree(trees, t: int, leaf_shift: float = 0.0,
                 leaf_flip: bool = False) -> bytes:
    if leaf_flip or leaf_shift:
        # copy-on-write of THIS tree's leaves only (a shallow list copy;
        # deep-copying every tree here would make export O(ntrees²)).
        # leaf_shift bakes the class's WHOLE init margin into this tree
        # (the caller picks tree 0): the MOJO carries one scalar init_f,
        # and margins are additive, so one tree carrying +init_c on
        # every root-to-leaf path reproduces the class offset exactly.
        # leaf_flip turns per-tree p1 leaves into the class-0
        # probabilities DrfMojoModel expects.
        import copy

        trees = copy.copy(trees)
        trees.leaf = list(trees.leaf)
        lf = trees.leaf[t].astype(np.float64)
        if leaf_flip:
            lf = 1.0 - lf
        trees.leaf[t] = (lf + leaf_shift).astype(np.float32)
    if not trees.is_split[t][0]:
        return b"\x00\xff\xff" + struct.pack(
            "<f", float(trees.leaf[t][0]))
    return _encode_subtree(trees, t, 0, trees.edges)


def _encode_raw_tree(is_split, feat, thresh, leaf) -> bytes:
    """Encode one raw-threshold heap tree (isolation forest): NaN routes
    left at every split, leaves carry float path lengths."""
    import types

    shim = types.SimpleNamespace(
        is_split=[np.asarray(is_split)],
        feat=[np.asarray(feat)],
        leaf=[np.asarray(leaf)],
        default_left=[np.ones(len(feat), bool)],
        split_bin=[np.zeros(len(feat), np.int32)],
        edges=np.zeros((0, 0)),
    )
    if not is_split[0]:
        return b"\x00\xff\xff" + struct.pack("<f", float(leaf[0]))
    return _encode_subtree(shim, 0, 0, shim.edges, raw_thresh=thresh)


# ---------------------------------------------------------------------------
# writer


def _zip_write(path: str, ini_lines: List[str],
               domain_texts: Dict[str, str],
               blobs: Dict[str, bytes]) -> str:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini_lines) + "\n")
        for name, text in domain_texts.items():
            z.writestr(name, text)
        for name, blob in blobs.items():
            z.writestr(name, blob)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return path


def _jdouble(v: float) -> str:
    """One double in Java Double.toString spelling: non-finite values are
    'Infinity'/'-Infinity'/'NaN' (Python repr's 'inf'/'nan' would misparse
    in a genuine h2o-genmodel reader's parseDouble)."""
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    return repr(v)


def _jarr(vals) -> str:
    """Java Arrays.toString formatting for a double[] ini value."""
    return "[" + ", ".join(_jdouble(v) for v in vals) + "]"


def _parse_jarr(s: str, cast=float):
    """Inverse of _jarr: parse a bracketed comma-joined kv array.
    float() natively accepts both the Java ('Infinity'/'NaN') and the
    Python ('inf'/'nan') spellings, so no special casing is needed."""
    body = s.strip()[1:-1].strip()
    return [cast(x) for x in body.split(",")] if body else []


def _glm_class_beta(info_d, cats, nums, coef: Dict[str, float]):
    """One class's flat beta in the reference layout: cats-first
    (catOffsets, skipping level 0 unless use_all_factor_levels), nums,
    intercept last. Returns (beta, cat_offsets)."""
    skip = 0 if info_d.use_all_factor_levels else 1
    cat_offsets = [0]
    beta: List[float] = []
    for c in cats:
        dom = info_d.cat_domains[c]
        for lv in dom[skip:]:
            beta.append(float(coef.get(f"{c}.{lv}", 0.0)))
        cat_offsets.append(len(beta))
    for n in nums:
        beta.append(float(coef.get(n, 0.0)))
    beta.append(float(coef.get("Intercept", 0.0)))
    return beta, cat_offsets


def _write_glm_mojo(model, path: str) -> str:
    """GLM in the reference layout (GLMMojoWriter.writeModelData /
    GlmMojoModel.glmScore0, GlmMultinomialMojoModel for multinomial):
    cats-first row layout, catOffsets into a flat raw-scale beta, num
    block, intercept last; multinomial concatenates the per-class betas
    class-major (beta[i + c*P])."""
    p = model.params
    if p.family == "ordinal":
        raise ValueError("reference-format GLM MOJO does not cover the "
                         "ordinal family (thresholded cumulative etas "
                         "have no GlmMojoModel analogue)")
    info_d = model.data_info
    cats = [n for n in info_d.predictor_names if n in info_d.cat_domains]
    nums = [n for n in info_d.predictor_names
            if n not in info_d.cat_domains]
    if p.family == "multinomial":
        beta = []
        cat_offsets = None
        for lv in info_d.response_domain:
            cb, cat_offsets = _glm_class_beta(
                info_d, cats, nums, model.coefficients_multinomial[lv])
            beta.extend(cb)
    else:
        beta, cat_offsets = _glm_class_beta(
            info_d, cats, nums, model.coefficients)

    columns = cats + nums + [p.response_column]
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    di = 0
    for ci, c in enumerate(cats):
        dom = info_d.cat_domains[c]
        dom_lines.append(f"{ci}: {len(dom)} d{di:03d}.txt")
        dom_texts[f"domains/d{di:03d}.txt"] = "\n".join(dom) + "\n"
        di += 1
    rdom = info_d.response_domain
    if rdom:
        dom_lines.append(f"{len(columns) - 1}: {len(rdom)} d{di:03d}.txt")
        dom_texts[f"domains/d{di:03d}.txt"] = "\n".join(rdom) + "\n"

    nclasses = model.nclasses
    if p.family == "multinomial":
        category = "Multinomial"
    else:
        category = "Binomial" if nclasses == 2 else "Regression"
    kv = [
        ("algorithm", "Generalized Linear Model"),
        ("algo", "glm"),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(cats) + len(nums)),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("offset_column", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("use_all_factor_levels",
         "true" if info_d.use_all_factor_levels else "false"),
        ("cats", len(cats)),
        ("cat_modes", "[" + ", ".join(
            str(info_d.cat_mode[c]) for c in cats) + "]"),
        ("cat_offsets", "[" + ", ".join(map(str, cat_offsets)) + "]"),
        ("nums", len(nums)),
        ("num_means", "[" + ", ".join(
            _jdouble(info_d.num_means[n]) for n in nums) + "]"),
        ("mean_imputation",
         "true" if info_d.missing_values_handling == "mean_imputation"
         else "false"),
        ("beta", "[" + ", ".join(_jdouble(b) for b in beta) + "]"),
        ("family", p.family),
        ("link", p.actual_link()),
        ("tweedie_link_power", p.tweedie_link_power),
    ]
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    return _zip_write(path, lines, dom_texts, {})


def _write_gam_mojo(model, path: str) -> str:
    """GAM (cubic-regression smoothers) in the reference layout
    (``hex/gam/GAMMojoWriter.java`` / ``GamMojoReader.java``): the
    artifact carries knots, ``_binvD`` (= B⁻¹D) and ``zTranspose`` per
    smoother as big-endian double blobs, the gam column-name text files,
    and both the centered and de-centered GLM betas; the scorer
    re-gamifies each row with ``GamUtilsCubicRegression`` and evaluates
    ``beta_center``. The training-side basis construction
    (``models/gam.py cr_basis``) is the same a/c-function algebra, so
    in-range rows score identically; outside the boundary knots the
    reference extrapolates the boundary-bin cubic while training used
    linear extrapolation — only such rows can differ.

    Covered: every-smoother-CR (bs=0), non-multinomial families,
    standardize=False. Thin-plate needs the polynomial-basis machinery
    (``GamUtilsThinPlateRegression``) and I-/M-splines have no genmodel
    scorer at all — all three refuse rather than export an artifact
    that scores differently."""
    p = model.params
    if any(s.kind != 0 for s in model.specs):
        raise ValueError(
            "reference-format GAM MOJO covers cubic-regression smoothers "
            "(bs=0) only; thin-plate needs GamUtilsThinPlateRegression's "
            "polynomial machinery and I-/M-splines have no genmodel "
            "scorer")
    if p.family in ("multinomial", "ordinal"):
        raise ValueError("reference-format GAM MOJO covers non-"
                         "multinomial families only")
    if p.standardize:
        raise ValueError("reference-format GAM MOJO export requires "
                         "standardize=False (the reference stores raw-"
                         "scale betas)")
    info_d = model.data_info
    cats = [n for n in info_d.predictor_names if n in info_d.cat_domains]
    nums = [n for n in info_d.predictor_names
            if n not in info_d.cat_domains]
    # linear betas permuted cats-first (same layout as the GLM writer)
    lin_beta, cat_offsets = _glm_class_beta(
        info_d, cats, nums, model.coefficients)
    lin_beta = lin_beta[:-1]  # intercept re-appended after the gam block
    intercept = float(model.coefficients["Intercept"])

    specs = model.specs
    n_gam = len(specs)
    n_lin = info_d.n_coefs
    # centered gam coefficients straight from the solved beta blocks
    gam_center: List[np.ndarray] = []
    off = n_lin
    for s in specs:
        kz = len(s.knots) - 1
        gam_center.append(np.asarray(model.beta[off:off + kz], np.float64))
        off += kz
    gam_no_center = [s.Z @ g for s, g in zip(specs, gam_center)]

    beta_center = lin_beta + [float(v) for g in gam_center for v in g] \
        + [intercept]
    beta_no_center = lin_beta + [float(v) for g in gam_no_center
                                 for v in g] + [intercept]

    gam_col_names = [[f"{s.column}_cr_{i}" for i in range(len(s.knots))]
                     for s in specs]
    gam_col_names_center = [
        [f"{s.column}_cr_{i}" for i in range(len(s.knots) - 1)]
        for s in specs]
    names_no_centering = (cats + nums
                          + [n for blk in gam_col_names for n in blk])
    columns = (cats + nums
               + [n for blk in gam_col_names_center for n in blk]
               + [p.response_column])

    dom_texts: Dict[str, str] = {}
    dom_lines = []
    di = 0
    for ci, c in enumerate(cats):
        dom = info_d.cat_domains[c]
        dom_lines.append(f"{ci}: {len(dom)} d{di:03d}.txt")
        dom_texts[f"domains/d{di:03d}.txt"] = "\n".join(dom) + "\n"
        di += 1
    rdom = info_d.response_domain
    if rdom:
        dom_lines.append(f"{len(columns) - 1}: {len(rdom)} d{di:03d}.txt")
        dom_texts[f"domains/d{di:03d}.txt"] = "\n".join(rdom) + "\n"

    # blobs: knots / zTranspose / _binvD, big-endian f64 (ByteBuffer)
    from h2o3_tpu_torch.models.gam import cr_matrices

    knots_blob = b"".join(
        np.asarray(s.knots, ">f8").tobytes() for s in specs)
    zt_blob = b"".join(
        np.ascontiguousarray(s.Z.T, ">f8").tobytes() for s in specs)
    binvd_blob = b""
    for s in specs:
        D, B = cr_matrices(np.asarray(s.knots))
        binvd_blob += np.ascontiguousarray(
            np.linalg.solve(B, D), ">f8").tobytes()

    n_expanded = sum(len(s.knots) for s in specs)
    n_expanded_center = sum(len(s.knots) - 1 for s in specs)
    nclasses = model.nclasses
    category = "Binomial" if nclasses == 2 else "Regression"
    kv: List[Tuple[str, Any]] = [
        ("algorithm", "Generalized Additive Model"),
        ("algo", "gam"),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(columns) - 1),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold",
         _jdouble(model.default_threshold()) if nclasses == 2 else 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("use_all_factor_levels",
         "true" if info_d.use_all_factor_levels else "false"),
        ("family", p.family),
        ("link", p.actual_link()),
        ("tweedie_link_power", p.tweedie_link_power),
        ("cats", len(cats)),
        ("cat_offsets", "[" + ", ".join(map(str, cat_offsets)) + "]"),
        ("catNAFills", "[" + ", ".join(
            str(info_d.cat_mode[c]) for c in cats) + "]"),
        ("num", len(nums) + n_expanded),
        ("numsCenter", len(nums) + n_expanded_center),
        ("numNAFillsCenter", _jarr(
            [info_d.num_means[n] for n in nums]
            + [0.0] * n_expanded_center)),
        ("mean_imputation",
         "true" if info_d.missing_values_handling == "mean_imputation"
         else "false"),
        ("beta length per class", len(beta_no_center)),
        ("beta center length per class", len(beta_center)),
        ("beta", _jarr(beta_no_center)),
        ("beta_center", _jarr(beta_center)),
        ("num_expanded_gam_columns", n_expanded),
        ("num_expanded_gam_columns_center", n_expanded_center),
        ("num_knots", "[" + ", ".join(
            str(len(s.knots)) for s in specs) + "]"),
        ("num_knots_sorted", "[" + ", ".join(
            str(len(s.knots)) for s in specs) + "]"),
        ("gam_column_dim", "[" + ", ".join(["1"] * n_gam) + "]"),
        ("gam_column_dim_sorted", "[" + ", ".join(["1"] * n_gam) + "]"),
        ("num_TP_col", 0),
        ("total feature size", len(names_no_centering)),
        ("bs", "[" + ", ".join(["0"] * n_gam) + "]"),
        ("bs_sorted", "[" + ", ".join(["0"] * n_gam) + "]"),
        ("gamColName_dim", "[" + ", ".join(
            str(len(s.knots)) for s in specs) + "]"),
        ("_d", "[" + ", ".join(["1"] * n_gam) + "]"),
    ]
    dom_texts["gam_columns"] = "\n".join(s.column for s in specs) + "\n"
    dom_texts["gam_columns_sorted"] = dom_texts["gam_columns"]
    dom_texts["_names_no_centering"] = "\n".join(names_no_centering) + "\n"
    dom_texts["gamColNames"] = "\n".join(
        n for blk in gam_col_names for n in blk) + "\n"
    dom_texts["gamColNamesCenter"] = "\n".join(
        n for blk in gam_col_names_center for n in blk) + "\n"
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    return _zip_write(path, lines, dom_texts, {
        "knots": knots_blob,
        "zTranspose": zt_blob,
        "_binvD": binvd_blob,
    })


def _write_kmeans_mojo(model, path: str) -> str:
    """KMeans in the reference layout (KMeansMojoWriter.writeModelData /
    KMeansMojoModel.score0): standardize means/mults/modes kv arrays plus
    one ``center_<i>`` kv per centroid, distance in standardized space.

    Numeric predictors only: the reference scorer keeps categorical
    columns as single indicator-distance columns while this framework
    one-hot expands them into the design matrix — the two center layouts
    are not interconvertible, so categorical models raise."""
    info = model.data_info
    if info.cat_domains:
        raise ValueError("reference-format KMeans MOJO covers numeric "
                         "predictors only (the reference scorer's "
                         "categorical distance is not one-hot)")
    nums = list(info.predictor_names)
    standardize = bool(getattr(info, "standardize", False))
    centers = model.centers_std if standardize else model.centers
    centers = np.asarray(centers, np.float64)

    kv = [
        ("algorithm", "K-means"),
        ("algo", "kmeans"),
        ("category", "Clustering"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "false"),
        ("n_features", len(nums)),
        ("n_classes", 1),
        ("n_columns", len(nums)),
        ("n_domains", 0),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("standardize", "true" if standardize else "false"),
    ]
    # means are written even when standardize is off: the in-framework
    # scorer always mean-imputes NAs, and this extra kv lets the decoder
    # match it (a reference reader only consults these when standardize
    # is true — for NA rows on unstandardized models the reference
    # runtime itself cannot impute)
    kv.append(("standardize_means", _jarr(info.num_means[n] for n in nums)))
    if standardize:
        kv += [
            ("standardize_mults",
             _jarr(1.0 / max(info.num_sds[n], 1e-300) for n in nums)),
            ("standardize_modes",
             "[" + ", ".join(["-1"] * len(nums)) + "]"),
        ]
    kv.append(("center_num", centers.shape[0]))
    for i, c in enumerate(centers):
        kv.append((f"center_{i}", _jarr(c)))
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + nums + ["", "[domains]"]
    return _zip_write(path, lines, {}, {})


def _write_isofor_mojo(model, path: str) -> str:
    """Isolation forest in the reference layout
    (IsolationForestMojoWriter / IsolationForestMojoModel.unifyPreds):
    SharedTree-format trees whose leaves carry path lengths, plus
    min/max_path_length for the (max - sum)/(max - min) score."""
    feats, threshs, splits, plens = model.trees
    ntrees = feats.shape[0]
    names = list(model.data_info.predictor_names)
    info = [
        ("algorithm", "Isolation Forest"),
        ("algo", "isolation_forest"),
        ("category", "AnomalyDetection"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "false"),
        ("n_features", len(names)),
        ("n_classes", 1),
        ("n_columns", len(names)),
        ("n_domains", 0),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.40"),
        ("h2o_version", "h2o3-tpu"),
        ("n_trees", ntrees),
        ("n_trees_per_class", 1),
        # int fields on the reference model (IsolationForestMojoReader):
        # conservative rounding keeps every training score inside [0, 1]
        ("max_path_length", int(np.ceil(model.max_path_total))),
        ("min_path_length", int(np.floor(model.min_path_total))),
        ("output_anomaly_flag", "false"),
        ("_genmodel_encoding", "LabelEncoder"),
    ]
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in info]
    lines += ["", "[columns]"] + names + ["", "[domains]"]
    # training routes left on v <= cut; the MOJO runtime routes left on
    # v < thr (strict) — thr = nextafter(cut) makes the two identical for
    # every float32 input
    thr_adj = np.nextafter(
        np.asarray(threshs, np.float32), np.float32(np.inf))
    blobs = {
        f"trees/t00_{t:03d}.bin": _encode_raw_tree(
            splits[t], feats[t], thr_adj[t], plens[t])
        for t in range(ntrees)
    }
    return _zip_write(path, lines, {}, blobs)


def _write_word2vec_mojo(model, path: str) -> str:
    """Word2Vec in the reference layout (Word2VecMojoWriter): vec_size /
    vocab_size kv, a ``vocabulary`` text file (one escaped word per
    line), and a ``vectors`` blob of BIG-endian float32s — Java
    ByteBuffer's default order, unlike the little-endian tree bytes."""
    vecs = np.asarray(model.vectors, np.float32)
    V, D = vecs.shape
    kv = [
        ("algorithm", "Word2Vec"),
        ("algo", "word2vec"),
        ("category", "WordEmbedding"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "false"),
        ("n_features", 0),
        ("n_classes", 1),
        ("n_columns", 0),
        ("n_domains", 0),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("vec_size", D),
        ("vocab_size", V),
    ]
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]", "", "[domains]"]
    vocab_text = "\n".join(
        _escape_vocab_word(w) for w in model.words
    ) + "\n"
    blobs = {"vectors": vecs.astype(">f4").tobytes()}
    return _zip_write(path, lines, {"vocabulary": vocab_text}, blobs)


def _escape_vocab_word(w: str) -> str:
    """One word per line: every character splitlines() treats as a line
    boundary must be escaped, or the vocab/vector zip misaligns."""
    out = []
    for ch in w:
        if ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch in "\v\f\x1c\x1d\x1e\x85\u2028\u2029":
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def _unescape_vocab_word(s: str) -> str:
    """Single left-to-right scan — sequential str.replace calls corrupt
    words containing a literal backslash followed by 'n'."""
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "r":
                out.append("\r")
                i += 2
                continue
            if nxt == "u" and i + 6 <= len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _write_dl_mojo(model, path: str) -> str:
    """DeepLearning in the reference layout (DeepLearningMojoWriter /
    DeeplearningMojoModel.score0): neural_network_sizes + per-layer
    weight/bias kv arrays, weights flattened ROW-major [out, in]
    (gemv_row_optimized order; this framework stores [in, out]).

    Numeric predictors only (the reference scorer's cats-first
    setInput layout differs from this framework's interleaved design
    matrix) and non-autoencoder. Hidden dropout ratios are written as 0:
    training uses inverted dropout, so inference-time scaling is already
    baked into the weights. The maxout family degrades to Rectifier in
    this build, so it exports as Rectifier — the artifact reproduces
    this model's predictions, not the reference's maxout."""
    info = model.data_info
    if info.cat_domains:
        raise ValueError("reference-format DeepLearning MOJO covers "
                         "numeric predictors only")
    if model.params.autoencoder:
        raise ValueError("reference-format DeepLearning MOJO does not "
                         "cover autoencoder models")
    nums = list(info.predictor_names)
    F = len(nums)
    net = [(np.asarray(W, np.float64), np.asarray(b, np.float64))
           for W, b in model.net_params]
    units = [F] + [w.shape[1] for w, _ in net]
    nclasses = model.nclasses
    is_clf = model.is_classifier
    act = {"rectifier": "Rectifier", "relu": "Rectifier", "tanh": "Tanh",
           "maxout": "Rectifier"}[model.params.activation]
    if is_clf:
        family = "bernoulli" if nclasses == 2 else "multinomial"
        category = "Binomial" if nclasses == 2 else "Multinomial"
    else:
        family = "gaussian"
        category = "Regression"

    columns = nums + [model.params.response_column]
    rdom = info.response_domain
    kv = [
        ("algorithm", "Deep Learning"),
        ("algo", "deeplearning"),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", F),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", 1 if rdom else 0),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.10"),
        ("h2o_version", "h2o3-tpu"),
        ("mini_batch_size", 1),
        ("nums", F),
        ("cats", 0),
        ("cat_offsets", "[0]"),
        ("use_all_factor_levels",
         "true" if info.use_all_factor_levels else "false"),
        ("activation", act),
        ("distribution", family),
        ("mean_imputation", "true"),
        ("norm_resp_mul", "null"),
        ("norm_resp_sub", "null"),
        ("neural_network_sizes", "[" + ", ".join(map(str, units)) + "]"),
        ("hidden_dropout_ratios", _jarr([0.0] * len(net))),
        ("_genmodel_encoding", "AUTO"),
    ]
    means = np.asarray([info.num_means[n] for n in nums], np.float64)
    if getattr(info, "standardize", False):
        kv.append(("norm_sub", _jarr(means)))
        kv.append(("norm_mul",
                   _jarr(1.0 / max(info.num_sds[n], 1e-300)
                        for n in nums)))
    else:
        # the scorer's NaN handling is ZERO-after-normalization; this
        # model mean-imputes. Writing norm_sub=means/norm_mul=1 makes the
        # scorer's NaN -> 0 equal mean-imputation, and the mean shift on
        # non-NaN values is folded into the first-layer bias exactly:
        # (x - m)·W0 + (b0 + m·W0) == x·W0 + b0
        kv.append(("norm_sub", _jarr(means)))
        kv.append(("norm_mul", _jarr(np.ones(F))))
        W0, b0 = net[0]
        net[0] = (W0, b0 + means @ W0)
    for i, (W, b) in enumerate(net):
        kv.append((f"weight_layer{i}", _jarr(W.T.reshape(-1))))
        kv.append((f"bias_layer{i}", _jarr(b)))
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"]
    dom_texts: Dict[str, str] = {}
    if rdom:
        lines.append(f"{len(columns) - 1}: {len(rdom)} d000.txt")
        dom_texts["domains/d000.txt"] = "\n".join(rdom) + "\n"
    return _zip_write(path, lines, dom_texts, {})


def _write_pca_mojo(model, path: str) -> str:
    """PCA in the reference layout (PCAMojoWriter / PCAMojoModel.score0):
    eigenvectors_raw blob of big-endian doubles [ncoefs, k] in CATS-FIRST
    coefficient order, normSub/normMul over the num block, catOffsets,
    and a permutation mapping the cats-first positions back to this
    model's column order. NA semantics differ from in-framework predict
    (the reference skips NA cats and propagates NaN nums; this framework
    mean/mode-imputes), so parity holds on NA-free rows."""
    info = model.data_info
    k = model.eigenvectors.shape[1]
    # our expanded design matrix is interleaved in predictor order;
    # reorder its rows into the cats-first layout the scorer expects
    order, cat_offsets, cats, nums = _coefs_cats_first(info)
    ev = np.asarray(model.eigenvectors, np.float64)[order]  # [ncoefs, k]

    # permutation: raw-row position (predictor order) of each cats-first
    # column index
    pos = {name: i for i, name in enumerate(info.predictor_names)}
    permutation = [pos[c] for c in cats] + [pos[n] for n in nums]

    # normSub/normMul carry the training-time transform. This model's
    # demean/descale statistics cover the EXPANDED matrix (one-hot cat
    # columns included), but the reference scorer only normalizes the
    # num block — those modes are not representable in the format
    transform = getattr(model.params, "transform",
                        "standardize" if getattr(info, "standardize", False)
                        else "none")
    if transform in ("demean", "descale"):
        raise ValueError(
            "reference-format PCA MOJO covers transform='standardize' or "
            "'none'; demean/descale statistics span the expanded one-hot "
            "columns, which PCAMojoModel's num-only normalization cannot "
            "express")
    if transform == "standardize":
        sub = [info.num_means[n] for n in nums]
        mul = [1.0 / max(info.num_sds[n], 1e-300) for n in nums]
    else:
        sub = [0.0] * len(nums)
        mul = [1.0] * len(nums)

    columns = cats + nums
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    for ci, c in enumerate(cats):
        dom = info.cat_domains[c]
        dom_lines.append(f"{ci}: {len(dom)} d{ci:03d}.txt")
        dom_texts[f"domains/d{ci:03d}.txt"] = "\n".join(dom) + "\n"
    kv = [
        ("algorithm", "Principal Components Analysis"),
        ("algo", "pca"),
        ("category", "DimReduction"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "false"),
        ("n_features", len(columns)),
        ("n_classes", 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("pcaMethod", "GramSVD"),
        ("pca_impl", "MTJ_EVD_SYMMMATRIX"),
        ("k", k),
        ("use_all_factor_levels",
         "true" if info.use_all_factor_levels else "false"),
        ("permutation", "[" + ", ".join(map(str, permutation)) + "]"),
        ("ncats", len(cats)),
        ("nnums", len(nums)),
        ("normSub", _jarr(sub)),
        ("normMul", _jarr(mul)),
        ("catOffsets", "[" + ", ".join(map(str, cat_offsets)) + "]"),
        ("eigenvector_size", ev.shape[0]),
    ]
    lines = ["[info]"]
    lines += [f"{k_} = {v}" for k_, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    blobs = {"eigenvectors_raw": ev.astype(">f8").tobytes()}
    return _zip_write(path, lines, dom_texts, blobs)


def _coefs_cats_first(info):
    """(order, cat_offsets, cats, nums): indices reordering this
    framework's interleaved expanded coefficient space into the
    reference's cats-first layout."""
    cats = [n for n in info.predictor_names if n in info.cat_domains]
    nums = [n for n in info.predictor_names if n not in info.cat_domains]
    skip = 0 if info.use_all_factor_levels else 1
    offsets = {}
    off = 0
    for name in info.predictor_names:
        offsets[name] = off
        off += (len(info.cat_domains[name]) - skip
                if name in info.cat_domains else 1)
    order: List[int] = []
    cat_offsets = [0]
    for c in cats:
        width = len(info.cat_domains[c]) - skip
        order.extend(range(offsets[c], offsets[c] + width))
        cat_offsets.append(cat_offsets[-1] + width)
    for n in nums:
        order.append(offsets[n])
    return order, cat_offsets, cats, nums


def _write_coxph_mojo(model, path: str) -> str:
    """CoxPH in the reference layout (CoxPHMojoWriter /
    CoxPHMojoModel.score0): cats-first coef kv, x_mean_cat/x_mean_num
    rectangular blobs (big-endian doubles + _size1/_size2 kv) whose
    coef-weighted sum forms lpBase, so the scored linear predictor is
    coef·(x − x̄) exactly like this framework's predict. No strata
    (strata_count = 0; the reference scorer then always uses row 0)."""
    info = model.data_info
    order, cat_offsets, cats, nums = _coefs_cats_first(info)
    beta = np.asarray(model.beta, np.float64)[order]
    means = np.asarray(model.feature_means, np.float64).reshape(-1)[order]
    ncatc = cat_offsets[-1]
    columns = cats + nums
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    for ci, c in enumerate(cats):
        dom = info.cat_domains[c]
        dom_lines.append(f"{ci}: {len(dom)} d{ci:03d}.txt")
        dom_texts[f"domains/d{ci:03d}.txt"] = "\n".join(dom) + "\n"
    kv = [
        ("algorithm", "CoxPH"),
        ("algo", "coxph"),
        ("category", "CoxPH"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(columns)),
        ("n_classes", 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("coef", _jarr(beta)),
        ("cats", len(cats)),
        ("cat_offsets", "[" + ", ".join(map(str, cat_offsets)) + "]"),
        ("use_all_factor_levels",
         "true" if info.use_all_factor_levels else "false"),
        ("x_mean_cat_size1", 1),
        ("x_mean_cat_size2", ncatc),
        ("x_mean_num_size1", 1),
        ("x_mean_num_size2", len(nums)),
        ("strata_count", 0),
    ]
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    blobs = {
        "x_mean_cat": means[:ncatc].astype(">f8").tobytes(),
        "x_mean_num": means[ncatc:].astype(">f8").tobytes(),
    }
    return _zip_write(path, lines, dom_texts, blobs)


def _write_te_mojo(model, path: str) -> str:
    """TargetEncoder in the reference layout (TargetEncoderMojoWriter):
    an ``encoding_map.ini`` of ``[column]`` sections with
    ``code = numerator denominator`` lines, NA-presence and column
    mapping files under ``feature_engineering/target_encoding/``, and
    blending kv. This framework's NA handling maps unseen/missing
    levels to the prior, which is the reference scorer's path when the
    column's NA-presence flag is 0 — so every flag is written 0."""
    p = model.params
    cols = list(model.encodings)
    columns = cols + [p.response_column]
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    for ci, c in enumerate(cols):
        dom = model.encodings[c][0]
        dom_lines.append(f"{ci}: {len(dom)} d{ci:03d}.txt")
        dom_texts[f"domains/d{ci:03d}.txt"] = "\n".join(dom) + "\n"
    rdom = model.data_info.response_domain
    if rdom:
        dom_lines.append(
            f"{len(columns) - 1}: {len(rdom)} d{len(cols):03d}.txt")
        dom_texts[f"domains/d{len(cols):03d}.txt"] = "\n".join(rdom) + "\n"

    kv = [
        ("algorithm", "TargetEncoder"),
        ("algo", "targetencoder"),
        ("category", "TargetEncoder"),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(cols)),
        ("n_classes", 2 if rdom else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("keep_original_categorical_columns",
         "true" if p.keep_original_categorical_columns else "false"),
        ("with_blending", "true" if p.blending else "false"),
    ]
    if p.blending:
        kv.append(("inflection_point", p.inflection_point))
        kv.append(("smoothing", p.smoothing))
    kv.append(("non_predictors", p.response_column))

    base = "feature_engineering/target_encoding"
    enc_lines = []
    for c in cols:
        dom, num, den = model.encodings[c]
        enc_lines.append(f"[{c}]")
        for code in range(len(dom)):
            enc_lines.append(
                f"{code} = {float(num[code])!r} {float(den[code])!r}")
        # the reference scorer derives each column's prior as
        # Σnum/Σden over its map; rows whose code was NA are absent from
        # the per-level sums, so without correction the map prior would
        # drift from this model's global prior_mean. One synthetic
        # category (an unused code — levels only go to len(dom)-1, and
        # the NA-presence flag is 0 so it is never looked up) restores
        # Σnum/Σden == prior_mean exactly.
        resid_den = 1.0
        resid_num = model.prior_mean * (float(den.sum()) + resid_den) \
            - float(num.sum())
        enc_lines.append(f"{len(dom)} = {resid_num!r} {resid_den!r}")
    dom_texts[f"{base}/encoding_map.ini"] = "\n".join(enc_lines) + "\n"
    dom_texts[f"{base}/te_column_name_to_missing_values_presence.ini"] = (
        "\n".join(f"{c} = 0" for c in cols) + "\n")
    dom_texts[f"{base}/input_encoding_columns_map.ini"] = "\n".join(
        f"[from]\n{c}\n[to]\n{c}" for c in cols) + "\n"
    dom_texts[f"{base}/input_output_columns_map.ini"] = "\n".join(
        f"[from]\n{c}\n[to]\n{c}_te" for c in cols) + "\n"

    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    return _zip_write(path, lines, dom_texts, {})


def _write_ensemble_mojo(model, path: str) -> str:
    """StackedEnsemble in the reference layout (StackedEnsembleMojoWriter
    / MultiModelMojoWriter): the metalearner and every base model are
    full MOJOs embedded under ``models/<algo>/<key>/``, with parent kv
    naming the metalearner and ``base_model<i>`` keys. Every sub-model
    must itself be reference-exportable."""
    import tempfile

    sub_entries: Dict[str, bytes] = {}

    def embed(sub) -> str:
        key = str(sub.key)
        with tempfile.NamedTemporaryFile(suffix=".zip") as tf:
            write_mojo(sub, tf.name)
            with zipfile.ZipFile(tf.name) as sz:
                for nm in sz.namelist():
                    sub_entries[f"models/{sub.algo_name}/{key}/{nm}"] = \
                        sz.read(nm)
        return key

    meta_key = embed(model.metalearner)
    base_keys = [embed(bm) for bm in model.base_models]

    info = model.data_info
    cats = [n for n in info.predictor_names if n in info.cat_domains]
    nums = [n for n in info.predictor_names if n not in info.cat_domains]
    columns = cats + nums + [info.response_name]
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    for ci, c in enumerate(cats):
        dom = info.cat_domains[c]
        dom_lines.append(f"{ci}: {len(dom)} d{ci:03d}.txt")
        dom_texts[f"domains/d{ci:03d}.txt"] = "\n".join(dom) + "\n"
    rdom = info.response_domain
    if rdom:
        dom_lines.append(
            f"{len(columns) - 1}: {len(rdom)} d{len(cats):03d}.txt")
        dom_texts[f"domains/d{len(cats):03d}.txt"] = "\n".join(rdom) + "\n"
    nclasses = model.nclasses
    category = ("Binomial" if nclasses == 2
                else "Multinomial" if nclasses > 2 else "Regression")
    kv = [
        ("algorithm", "StackedEnsemble"),
        ("algo", "stackedensemble"),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(cats) + len(nums)),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.01"),
        ("h2o_version", "h2o3-tpu"),
        ("submodel_count", 1 + len(base_keys)),
        ("base_models_num", len(base_keys)),
        ("metalearner", meta_key),
        ("metalearner_transform", "NONE"),
    ]
    for i, key in enumerate(base_keys):
        kv.append((f"base_model{i}", key))
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    return _zip_write(path, lines, dom_texts, sub_entries)


def _model_feature_schema(model) -> List[Tuple[str, Optional[List[str]]]]:
    """(name, domain) of a model's feature columns in MOJO order
    (cats first, then nums — the DataInfo permutation every writer
    here uses)."""
    info = model.data_info
    cats = [n for n in info.predictor_names if n in info.cat_domains]
    nums = [n for n in info.predictor_names if n not in info.cat_domains]
    return ([(c, list(info.cat_domains[c])) for c in cats]
            + [(n, None) for n in nums])


def write_pipeline_mojo(models: Dict[str, Any],
                        input_mapping: Dict[str, str],
                        main_alias: str, path: str) -> str:
    """Compose reference-exportable models into ONE pipeline MOJO in the
    reference layout (``hex/genmodel/MojoPipelineWriter.java``): every
    model embeds as a full MOJO under ``models/<alias>/`` with
    ``submodel_key_i``/``submodel_dir_i`` kvs; ``input_mapping`` maps a
    generated column name consumed by the main model to
    ``"<alias>:<prediction index>"`` of the sub-model producing it; the
    pipeline's input schema is derived exactly like
    ``deriveInputSchema`` (union of sub-model features + the main
    model's non-generated columns, response included)."""
    import tempfile

    if main_alias not in models:
        raise ValueError(f"Main model is missing. There is no model with "
                         f"alias '{main_alias}'.")
    main = models[main_alias]

    sub_entries: Dict[str, bytes] = {}
    for alias, m in models.items():
        with tempfile.NamedTemporaryFile(suffix=".zip") as tf:
            write_mojo(m, tf.name)
            with zipfile.ZipFile(tf.name) as sz:
                for nm in sz.namelist():
                    sub_entries[f"models/{alias}/{nm}"] = sz.read(nm)

    # deriveInputSchema: sub-model features first (domain conflicts are
    # an error), then the main model's columns not generated by a sub
    schema: List[Tuple[str, Optional[List[str]]]] = []
    seen: Dict[str, Optional[List[str]]] = {}
    for alias, m in models.items():
        if alias == main_alias:
            continue
        for name, dom in _model_feature_schema(m):
            if name in seen:
                if seen[name] != dom:
                    raise ValueError(
                        f"Domains of column '{name}' differ.")
                continue
            seen[name] = dom
            schema.append((name, dom))
    minfo = main.data_info
    main_cols = (_model_feature_schema(main)
                 + [(minfo.response_name,
                     list(minfo.response_domain)
                     if minfo.response_domain else None)])
    for name, dom in main_cols:
        if name in input_mapping or name in seen:
            continue
        seen[name] = dom
        schema.append((name, dom))

    columns = [n for n, _ in schema]
    dom_texts: Dict[str, str] = {}
    dom_lines = []
    di = 0
    for ci, (_n, dom) in enumerate(schema):
        if dom is None:
            continue
        dom_lines.append(f"{ci}: {len(dom)} d{di:03d}.txt")
        dom_texts[f"domains/d{di:03d}.txt"] = "\n".join(dom) + "\n"
        di += 1

    nclasses = main.nclasses
    category = ("Binomial" if nclasses == 2
                else "Multinomial" if nclasses > 2 else "Regression")
    kv: List[Tuple[str, Any]] = [
        ("algorithm", "MOJO Pipeline"),
        ("algo", "pipeline"),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true"),
        ("n_features", len(columns) - 1),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(dom_lines)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("mojo_version", "1.00"),
        ("h2o_version", "h2o3-tpu"),
        ("submodel_count", len(models)),
    ]
    for i, alias in enumerate(models):
        kv.append((f"submodel_key_{i}", alias))
        kv.append((f"submodel_dir_{i}", f"models/{alias}/"))
    kv.append(("generated_column_count", len(input_mapping)))
    for i, (gname, spec) in enumerate(input_mapping.items()):
        alias, _, idx = spec.partition(":")
        kv.append((f"generated_column_name_{i}", gname))
        kv.append((f"generated_column_model_{i}", alias))
        kv.append((f"generated_column_index_{i}", int(idx)))
    kv.append(("main_model", main_alias))

    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in kv]
    lines += ["", "[columns]"] + columns + ["", "[domains]"] + dom_lines
    return _zip_write(path, lines, dom_texts, sub_entries)


def write_mojo(model, path: str) -> str:
    """Serialize a GBM, DRF, GLM, GAM (CR smoothers), KMeans,
    IsolationForest, Word2Vec, DeepLearning, TargetEncoder, PCA, CoxPH,
    StackedEnsemble or pipeline model into the reference MOJO layout."""
    from h2o3_tpu_torch.models.tree.common import tree_feature_names

    algo = model.algo_name
    if getattr(model.params, "offset_column", None):
        # the format has no offset term; exporting would silently drop it
        raise ValueError("reference-format MOJO export does not support "
                         "offset_column models")
    writers = {
        "glm": _write_glm_mojo,
        "gam": _write_gam_mojo,
        "kmeans": _write_kmeans_mojo,
        "isolationforest": _write_isofor_mojo,
        "word2vec": _write_word2vec_mojo,
        "deeplearning": _write_dl_mojo,
        "targetencoder": _write_te_mojo,
        "pca": _write_pca_mojo,
        "coxph": _write_coxph_mojo,
        "stackedensemble": _write_ensemble_mojo,
    }
    if algo in writers:
        return writers[algo](model, path)
    if algo not in ("gbm", "drf"):
        covered = ", ".join(sorted(["gbm", "drf", *writers]))
        raise ValueError(
            f"reference-format MOJO export currently covers {covered}; "
            "use the native .mojo (models/mojo_export.py) or POJO "
            f"codegen for {algo}")
    b = model.booster
    names = tree_feature_names(model.data_info, model.tree_encoding)
    dom = model.data_info.response_domain
    nclasses = model.nclasses
    dist = model.distribution
    K = len(b.trees_per_class)
    ntrees = b.trees_per_class[0].ntrees
    supervised = True
    columns = list(names) + [model.params.response_column]
    cat_domains: Dict[int, List[str]] = {}
    # label-encoded tree features are numeric to the MOJO; only the
    # response carries a domain
    if dom:
        cat_domains[len(columns) - 1] = list(dom)

    if nclasses == 2:
        init_f = float(b.init_margin[0])
        category = "Binomial"
    elif nclasses > 2:
        init_f = 0.0  # per-class inits are baked into tree 0's leaves
        category = "Multinomial"
    else:
        init_f = float(b.init_margin[0])
        category = "Regression"
    if algo == "drf":
        init_f = 0.0  # DRF trains from zero margin; DrfMojoModel has no init

    info = [
        ("algorithm", "Gradient Boosting Machine" if algo == "gbm"
         else "Distributed Random Forest"),
        ("algo", algo),
        ("category", category),
        ("uuid", str(_uuid.uuid4())),
        ("supervised", "true" if supervised else "false"),
        ("n_features", len(names)),
        ("n_classes", nclasses if nclasses > 1 else 1),
        ("n_columns", len(columns)),
        ("n_domains", len(cat_domains)),
        ("balance_classes", "false"),
        ("default_threshold", 0.5),
        ("prior_class_distrib", "null"),
        ("model_class_distrib", "null"),
        ("offset_column", "null"),
        ("mojo_version", "1.40"),
        ("h2o_version", "h2o3-tpu"),
        ("n_trees", ntrees),
        ("n_trees_per_class", K),
        ("distribution", dist),
        ("link_function", _LINK_BY_DIST.get(dist, "identity")),
        ("init_f", _jdouble(init_f)),
    ]
    if algo == "drf":
        info.append(("binomial_double_trees", "false"))
    # mojo_version >= 1.40 readers call readkv("_genmodel_encoding")
    # .toString() unconditionally (SharedTreeMojoReader.java:25-28)
    enc = getattr(model, "tree_encoding", "label_encoder")
    info.append(("_genmodel_encoding",
                 "OneHotExplicit" if enc == "one_hot_explicit"
                 else "LabelEncoder"))
    lines = ["[info]"]
    lines += [f"{k} = {v}" for k, v in info]
    lines.append("")
    lines.append("[columns]")
    lines += columns
    lines.append("")
    lines.append("[domains]")
    for ci, (col, d) in enumerate(sorted(cat_domains.items())):
        # reference parseModelDomains expects '<col>: <n_elements> <file>'
        # (ModelMojoReader.java splits on space and parses the count)
        lines.append(f"{col}: {len(d)} d{ci:03d}.txt")

    dom_texts = {
        f"domains/d{ci:03d}.txt": "\n".join(d) + "\n"
        for ci, (col, d) in enumerate(sorted(cat_domains.items()))
    }
    blobs: Dict[str, bytes] = {}
    for c, trees in enumerate(b.trees_per_class):
        for t in range(trees.ntrees):
            shift = (float(b.init_margin[c])
                     if (algo == "gbm" and nclasses > 2 and t == 0)
                     else 0.0)
            # DrfMojoModel's binomial preds[1] is the CLASS-0
            # probability (preds[2] = 1 - preds[1]); our DRF trees
            # predict p1 per tree, so leaves flip to 1 - p
            flip = (algo == "drf" and nclasses == 2)
            blobs[f"trees/t{c:02d}_{t:03d}.bin"] = _encode_tree(
                trees, t, leaf_shift=shift, leaf_flip=flip)
    return _zip_write(path, lines, dom_texts, blobs)


# ---------------------------------------------------------------------------
# independent reader (SharedTreeMojoModel.scoreTree byte-walk)


class RefMojo:
    def __init__(self) -> None:
        self.info: Dict[str, str] = {}
        self.columns: List[str] = []
        self.domains: Dict[int, List[str]] = {}
        self.trees: List[List[bytes]] = []  # [class][tree]

    @property
    def nclasses(self) -> int:
        return int(self.info.get("n_classes", 1))

    def score_tree(self, tree: bytes, row: np.ndarray) -> float:
        """Exact scoreTree walk (SharedTreeMojoModel.java:130-215),
        float-split subset."""
        pos = 0
        while True:
            node_type = tree[pos]; pos += 1
            col_id = struct.unpack_from("<H", tree, pos)[0]; pos += 2
            if col_id == 65535:
                return struct.unpack_from("<f", tree, pos)[0]
            na_dir = tree[pos]; pos += 1
            na_vs_rest = na_dir == 1
            leftward = na_dir in (2, 4)
            lmask = node_type & 51
            equal = node_type & 12
            if equal != 0:
                raise ValueError(
                    "bitset categorical splits are not supported by this "
                    "reader (label-encoded models use float splits)")
            split_val = None
            if not na_vs_rest:
                split_val = struct.unpack_from("<f", tree, pos)[0]; pos += 4
            d = row[col_id]
            if np.isnan(d):
                go_right = not leftward
            elif na_vs_rest:
                go_right = False
            else:
                go_right = d >= split_val
            if go_right:
                if lmask <= 3:
                    n = int.from_bytes(tree[pos:pos + lmask + 1], "little")
                    pos += lmask + 1
                    pos += n
                elif lmask == 48:
                    pos += 4
                else:
                    raise ValueError(f"illegal lmask {lmask}")
                lmask = (node_type & 0xC0) >> 2
            else:
                if lmask <= 3:
                    pos += lmask + 1
            if lmask & 16:
                return struct.unpack_from("<f", tree, pos)[0]

    def _glm_arrays(self):
        """Parse the GLM kv arrays ONCE and cache (score0 is per-row)."""
        cached = getattr(self, "_glm_cache", None)
        if cached is not None:
            return cached

        def arr(key, cast=float):
            return _parse_jarr(self.info[key], cast)

        cached = {
            "cats": int(self.info["cats"]),
            "nums": int(self.info["nums"]),
            "cat_offsets": arr("cat_offsets", int),
            "beta": np.asarray(arr("beta"), np.float64),
            "cat_modes": (arr("cat_modes", int)
                          if "cat_modes" in self.info else []),
            "num_means": (arr("num_means")
                          if "num_means" in self.info else []),
        }
        self._glm_cache = cached
        return cached

    def _glm_score0(self, row: np.ndarray) -> np.ndarray:
        """GlmMojoModelBase.score0 + GlmMojoModel.glmScore0: cats-first
        row, mean imputation, catOffsets beta lookup, link inverse."""
        g = self._glm_arrays()
        cats, nums = g["cats"], g["nums"]
        cat_offsets, beta = g["cat_offsets"], g["beta"]
        data = np.asarray(row, np.float64).copy()
        if self.info.get("mean_imputation") == "true":
            for i in range(cats):
                if np.isnan(data[i]):
                    data[i] = g["cat_modes"][i]
            for i in range(nums):
                if np.isnan(data[cats + i]):
                    data[cats + i] = g["num_means"][i]
        use_all = self.info.get("use_all_factor_levels") == "true"

        def class_eta(cbeta):
            eta = 0.0
            for i in range(cats):
                # Java's (int) NaN is 0 — an unimputed NaN categorical
                # maps to level 0 exactly like the reference runtime
                iv = data[i]
                ival = (0 if np.isnan(iv) else int(iv)) - (
                    0 if use_all else 1)
                if ival < 0:
                    continue
                ival += cat_offsets[i]
                if ival < cat_offsets[i + 1]:
                    eta += cbeta[ival]
            noff = cat_offsets[cats] - cats
            for i in range(cats, len(cbeta) - 1 - noff):
                eta += cbeta[noff + i] * data[i]
            return eta + cbeta[-1]

        if self.info.get("family") == "multinomial":
            # GlmMultinomialMojoModel.glmScore0 — including its quirk of
            # seeding the max with 0, not -inf
            C = self.nclasses
            P = len(beta) // C
            etas = np.array([class_eta(beta[c * P:(c + 1) * P])
                             for c in range(C)])
            max_row = max(0.0, float(etas.max()))
            e = np.exp(etas - max_row)
            return e / e.sum()

        eta = class_eta(beta)
        link = self.info.get("link", "identity")
        if link == "logit":
            mu = 1.0 / (1.0 + np.exp(-eta))
        elif link == "log":
            mu = np.exp(eta)
        elif link == "inverse":
            d = eta if abs(eta) >= 1e-10 else (
                1e-10 if eta + 1e-30 >= 0 else -1e-10)
            mu = 1.0 / d
        elif link == "tweedie":
            lp = float(self.info.get("tweedie_link_power", 0.0))
            mu = np.exp(eta) if lp == 0 else max(eta, 1e-10) ** (1.0 / lp)
        else:
            mu = eta
        if self.info.get("family") in ("binomial", "quasibinomial"):
            return np.array([1.0 - mu, mu])
        return np.array([mu])

    def _kmeans_arrays(self):
        """Parse the KMeans kv arrays ONCE and cache (score0 is per-row)."""
        cached = getattr(self, "_kmeans_cache", None)
        if cached is not None:
            return cached

        def arr(key):
            return np.asarray(_parse_jarr(self.info[key]), np.float64)

        cached = {
            "centers": np.stack([
                arr(f"center_{i}")
                for i in range(int(self.info["center_num"]))
            ]),
            "means": (arr("standardize_means")
                      if "standardize_means" in self.info else None),
            "mults": (arr("standardize_mults")
                      if "standardize_mults" in self.info else None),
        }
        self._kmeans_cache = cached
        return cached

    def _kmeans_score0(self, row: np.ndarray) -> np.ndarray:
        """KMeansMojoModel.score0: Kmeans_preprocessData (NaN -> mean,
        subtract-mean times mult) then KMeans_closest in standardized
        space (numeric columns only in this exporter).

        NaN imputation uses standardize_means whenever the writer
        recorded them — this framework's writer emits them even for
        standardize=False models so the artifact can reproduce
        in-framework predictions on NA rows (the reference runtime only
        imputes when standardize is on; a reference reader ignores the
        extra key)."""
        km = self._kmeans_arrays()
        data = np.asarray(row, np.float64).copy()
        if km["means"] is not None:
            nan = np.isnan(data)
            data[nan] = km["means"][nan]
        if self.info.get("standardize") == "true":
            data = (data - km["means"]) * km["mults"]
        d2 = ((km["centers"] - data[None, :]) ** 2).sum(axis=1)
        return np.array([float(np.argmin(d2))])

    def _dl_arrays(self):
        cached = getattr(self, "_dl_cache", None)
        if cached is not None:
            return cached

        def arr(key):
            return np.asarray(_parse_jarr(self.info[key]), np.float64)

        units = [int(u) for u in arr("neural_network_sizes")]
        layers = []
        for i in range(len(units) - 1):
            W = arr(f"weight_layer{i}").reshape(units[i + 1], units[i])
            b = arr(f"bias_layer{i}")
            layers.append((W, b))
        cached = {
            "units": units,
            "layers": layers,
            "norm_sub": arr("norm_sub") if "norm_sub" in self.info else None,
            "norm_mul": arr("norm_mul") if "norm_mul" in self.info else None,
        }
        self._dl_cache = cached
        return cached

    def _dl_score0(self, row: np.ndarray) -> np.ndarray:
        """DeeplearningMojoModel.score0, numeric-only subset: setInput
        ((d - norm_sub) * norm_mul, NaN -> 0 after normalization), then
        fprop with the stored activation per hidden layer and
        Softmax/Linear on the output layer."""
        dl = self._dl_arrays()
        x = np.asarray(row, np.float64).copy()
        if dl["norm_sub"] is not None:
            x = (x - dl["norm_sub"]) * dl["norm_mul"]
        x[np.isnan(x)] = 0.0  # replaceMissingWithZero (post-normalization)
        act = self.info.get("activation", "Rectifier")
        n_layers = len(dl["layers"])
        for i, (W, b) in enumerate(dl["layers"]):
            x = W @ x + b
            if i < n_layers - 1:
                if act == "Tanh":
                    x = np.tanh(x)
                else:  # Rectifier
                    x = np.maximum(x, 0.0)
        if self.info.get("category") in ("Binomial", "Multinomial"):
            z = x - x.max()
            e = np.exp(z)
            return e / e.sum()
        return np.array([x[0]])

    def _pca_arrays(self):
        """Parse the PCA kv arrays ONCE and cache (score0 is per-row)."""
        cached = getattr(self, "_pca_cache", None)
        if cached is not None:
            return cached
        cached = {
            "ncats": int(self.info["ncats"]),
            "nnums": int(self.info["nnums"]),
            "k": int(self.info["k"]),
            "perm": _parse_jarr(self.info["permutation"], int),
            "cat_offsets": _parse_jarr(self.info["catOffsets"], int),
            "sub": np.asarray(_parse_jarr(self.info["normSub"])),
            "mul": np.asarray(_parse_jarr(self.info["normMul"])),
        }
        self._pca_cache = cached
        return cached

    def _pca_score0(self, row: np.ndarray) -> np.ndarray:
        """PCAMojoModel.score0: per component, sum the one-hot cat
        eigenvector entries (NA cats skipped) plus normalized nums times
        the num-block entries."""
        p = self._pca_arrays()
        ncats, nnums, kcomp = p["ncats"], p["nnums"], p["k"]
        perm, cat_offsets = p["perm"], p["cat_offsets"]
        sub, mul = p["sub"], p["mul"]
        use_all = self.info.get("use_all_factor_levels") == "true"
        ev = self.eigenvectors
        num_start = cat_offsets[ncats]
        out = np.zeros(kcomp)
        for j in range(ncats):
            v = row[perm[j]]
            if np.isnan(v):
                continue  # missing categoricals are skipped
            last = cat_offsets[j + 1] - cat_offsets[j] - 1
            level = int(v) - (0 if use_all else 1)
            if level < 0 or level > last:
                continue  # unseen test level
            out += ev[cat_offsets[j] + level]
        for j in range(nnums):
            out += (row[perm[ncats + j]] - sub[j]) * mul[j] * \
                ev[num_start + j]
        return out

    def _ensemble_score0(self, row: np.ndarray) -> np.ndarray:
        """StackedEnsembleMojoModel.score0: score every base model on the
        (re-mapped) row, stack the level-one vector in base order
        (binomial p1 / regression pred / multinomial all classes), then
        score the metalearner on it."""
        nclasses = self.nclasses
        # parent row layout = parent columns minus the response; each
        # sub-model expects ITS column order — remap by name, computed
        # once (score0 is per-row)
        remaps = getattr(self, "_ensemble_remaps", None)
        if remaps is None:
            pos = {c: i for i, c in enumerate(self.columns[:-1])}
            remaps = [
                None if bm is None
                else np.asarray([pos[c] for c in bm.columns[:-1]], np.intp)
                for bm in self.base_models
            ]
            self._ensemble_remaps = remaps
        base_preds: List[float] = []
        for bm, idx in zip(self.base_models, remaps):
            if bm is None:
                continue
            sub_row = row[idx]
            out = bm.score0(sub_row)
            if nclasses > 2:
                base_preds.extend(out)
            elif nclasses == 2:
                base_preds.append(out[-1])  # p1 (preds[2] in the runtime)
            else:
                base_preds.append(out[0])
        if self.info.get("metalearner_transform") == "Logit":
            base_preds = [
                float(np.log(max(min(p, 1 - 1e-9), 1e-9)
                             / (1 - max(min(p, 1 - 1e-9), 1e-9))))
                for p in base_preds
            ]
        return self.metalearner.score0(np.asarray(base_preds, np.float64))

    def _coxph_score0(self, row: np.ndarray) -> np.ndarray:
        """CoxPHMojoModel.score0 (no strata): lp = forCategories +
        forOtherColumns − lpBase, with lpBase = x̄·coef from the
        x_mean_cat/x_mean_num blobs — i.e. coef·(x − x̄)."""
        cached = getattr(self, "_coxph_cache", None)
        if cached is None:
            coef = np.asarray(_parse_jarr(self.info["coef"]))
            cat_offsets = _parse_jarr(self.info["cat_offsets"], int)
            ncatc = cat_offsets[-1]
            means = np.concatenate([self.x_mean_cat, self.x_mean_num])
            cached = {
                "coef": coef,
                "cat_offsets": cat_offsets,
                "cats": int(self.info["cats"]),
                "lp_base": float(means @ coef),
                "use_all": self.info.get(
                    "use_all_factor_levels") == "true",
                "ncatc": ncatc,
            }
            self._coxph_cache = cached
        coef = cached["coef"]
        cat_offsets = cached["cat_offsets"]
        cats = cached["cats"]
        lp = 0.0
        for j in range(cats):
            v = row[j]
            if np.isnan(v):
                continue
            level = int(v) - (0 if cached["use_all"] else 1)
            if level < 0 or level >= cat_offsets[j + 1] - cat_offsets[j]:
                continue
            lp += coef[cat_offsets[j] + level]
        for j in range(len(coef) - cached["ncatc"]):
            lp += coef[cached["ncatc"] + j] * row[cats + j]
        return np.array([lp - cached["lp_base"]])

    def te_transform(self, levels: Dict[str, float]) -> Dict[str, float]:
        """TargetEncoderMojoModel.score0 semantics: per encoded column,
        numerator/denominator lookup by level code with optional blending
        against the column map's prior (Σnum/Σden); NaN/unseen levels
        take the prior (every NA-presence flag is written 0)."""
        blending = self.info.get("with_blending") == "true"
        k = float(self.info.get("inflection_point", 10.0))
        f = float(self.info.get("smoothing", 20.0))
        priors = getattr(self, "_te_priors", None)
        if priors is None:  # per-column Σnum/Σden, computed once
            priors = {
                col: (sum(v[0] for v in emap.values())
                      / max(sum(v[1] for v in emap.values()), 1e-300))
                for col, emap in self.te_encodings.items()
            }
            self._te_priors = priors
        bounds = getattr(self, "_te_bounds", None)
        if bounds is None:
            # valid level codes come from the column's DOMAIN, not the
            # map length: this writer appends one synthetic
            # prior-correction entry past the domain (never a real
            # level), while a foreign reference writer emits exactly the
            # domain — either way the domain bound is right
            bounds = {}
            for col in self.te_columns:
                try:
                    ci = self.columns.index(col)
                    bounds[col] = len(self.domains[ci])
                except (ValueError, KeyError):
                    bounds[col] = len(self.te_encodings[col]) - 1
            self._te_bounds = bounds
        out: Dict[str, float] = {}
        for col in self.te_columns:
            emap = self.te_encodings[col]
            prior = priors[col]
            cat = levels.get(col, float("nan"))
            # a level inside the domain can still be absent from a
            # foreign writer's map (unseen in training): prior fallback
            if cat is None or (isinstance(cat, float) and np.isnan(cat)) \
                    or not (0 <= int(cat) < bounds[col]) \
                    or int(cat) not in emap:
                out[f"{col}_te"] = prior
                continue
            num, den = emap[int(cat)]
            post = num / den if den else prior
            if blending:
                lam = 1.0 / (1.0 + np.exp((k - den) / max(f, 1e-12)))
                post = lam * post + (1.0 - lam) * prior
            out[f"{col}_te"] = post
        return out

    @property
    def nfeatures(self) -> int:
        return int(self.info.get("n_features", len(self.columns)))

    # -- GAM (GamMojoModel + GamUtilsCubicRegression, ported) --------------
    @staticmethod
    def _gam_locate_bin(x: float, knots: np.ndarray) -> int:
        """GamUtilsCubicRegression.locateBin — boundary values clamp to
        the first/last bin (the cubic then EXTRAPOLATES with raw x)."""
        if x <= knots[0]:
            return 0
        if x >= knots[-1]:
            return len(knots) - 2
        return int(np.searchsorted(knots, x, side="right") - 1)

    def _gam_expand_one(self, x: float, ci: int) -> np.ndarray:
        """expandOneGamCol: the K basis values of smoother ci at x."""
        knots = self.gam_knots[ci]
        binvd = self.gam_binvd[ci]
        K = len(knots)
        vals = np.zeros(K)
        if np.isnan(x):
            return np.full(K, np.nan)
        j = self._gam_locate_bin(x, knots)
        hj = knots[j + 1] - knots[j]
        tm, tp = knots[j + 1] - x, x - knots[j]
        cmj = (tm ** 3 / hj - tm * hj) / 6.0
        cpj = (tp ** 3 / hj - tp * hj) / 6.0
        if j == 0:
            vals[:] = binvd[0] * cpj
        elif j >= binvd.shape[0]:
            vals[:] = binvd[j - 1] * cmj
        else:
            vals[:] = binvd[j - 1] * cmj + binvd[j] * cpj
        vals[j] += tm / hj
        vals[j + 1] += tp / hj
        return vals

    def gam_score0(self, row: Dict[str, float]) -> np.ndarray:
        """GamMojoModel.gamScore0 over a {column: value} row (cats as
        level codes, gam predictors as raw values): gamify each smoother
        column, center through zTranspose, evaluate beta_center."""
        cats = int(self.info.get("cats", 0))
        cat_offsets = _parse_jarr(self.info.get("cat_offsets", "[0]"), int)
        use_all = self.info.get("use_all_factor_levels") == "true"
        beta = np.asarray(_parse_jarr(self.info["beta_center"]))
        feats = self.columns[:-1]
        eta = 0.0
        for i in range(cats):
            ival = int(row[feats[i]])
            if not use_all:
                ival -= 1
            if ival >= 0:
                ival += cat_offsets[i]
                if ival < cat_offsets[i + 1]:
                    eta += beta[ival]
        noff = cat_offsets[cats] - cats
        # plain numeric features come before the gamified block
        n_center = sum(len(k) - 1 for k in self.gam_knots)
        for i in range(cats, len(feats) - n_center):
            eta += beta[noff + i] * row[feats[i]]
        pos = noff + len(feats) - n_center
        for ci, col in enumerate(self.gam_columns):
            basis = self._gam_expand_one(float(row[col]), ci)
            centered = self.gam_zt[ci] @ basis
            for v in centered:
                eta += beta[pos] * v
                pos += 1
        eta += beta[-1]
        fam = self.info.get("family", "gaussian")
        link = self.info.get("link", "identity")
        if link == "logit":
            mu = 1.0 / (1.0 + np.exp(-eta))
        elif link == "log":
            mu = np.exp(eta)
        else:
            mu = eta
        if fam in ("binomial", "quasibinomial", "fractionalbinomial"):
            return np.array([1.0 - mu, mu])
        return np.array([mu])

    def _pipeline_score0(self, row: np.ndarray) -> np.ndarray:
        """MojoPipeline.score0: copy passthrough inputs into the main
        model's row layout, score every sub-model to fill the generated
        columns, then score the main model."""
        main = self.pipeline_models[self.pipeline_main]
        gen_names = {g[0] for g in self.pipeline_gen}
        main_feats = main.columns[:main.nfeatures]
        main_row = np.full(main.nfeatures, np.nan)
        for ti, name in enumerate(main_feats):
            if name not in gen_names:
                main_row[ti] = row[self.columns.index(name)]
        for alias, sub in self.pipeline_models.items():
            if alias == self.pipeline_main:
                continue
            sub_row = np.array([
                row[self.columns.index(nm)]
                for nm in sub.columns[:sub.nfeatures]
            ])
            preds = sub.score0(sub_row)
            for gname, galias, gidx in self.pipeline_gen:
                if galias == alias:
                    main_row[main_feats.index(gname)] = preds[gidx]
        return main.score0(main_row)

    def score0(self, row: np.ndarray) -> np.ndarray:
        """Gbm/Drf/Glm/KMeansMojoModel semantics over the decoded payload."""
        algo = self.info.get("algo", "gbm")
        if algo == "targetencoder":
            raise ValueError(
                "TargetEncoder MOJOs transform rows rather than score "
                "them — use te_transform({column: level_code, ...})")
        if algo == "glm":  # no trees to walk
            return self._glm_score0(row)
        if algo == "deeplearning":
            return self._dl_score0(row)
        if algo == "pca":
            return self._pca_score0(row)
        if algo == "coxph":
            return self._coxph_score0(row)
        if algo == "stackedensemble":
            return self._ensemble_score0(row)
        if algo == "pipeline":
            return self._pipeline_score0(row)
        if algo == "kmeans":
            return self._kmeans_score0(row)
        if algo == "isolation_forest":
            # IsolationForestMojoModel.unifyPreds: sum of per-tree path
            # lengths -> normalized score + mean path length
            total = float(np.sum([
                self.score_tree(t, row) for t in self.trees[0]
            ], dtype=np.float64))
            ntrees = int(self.info.get("n_trees", 1))
            mx = float(self.info["max_path_length"])
            mn = float(self.info["min_path_length"])
            score = (mx - total) / (mx - mn) if mx > mn else 1.0
            return np.array([score, total / max(ntrees, 1)])
        init_f = float(self.info.get("init_f", 0.0))
        dist = self.info.get("distribution", "gaussian")
        link = self.info.get("link_function", "identity")
        sums = np.array([
            np.sum([self.score_tree(t, row) for t in cls], dtype=np.float32)
            for cls in self.trees
        ], dtype=np.float64)
        if algo == "drf":  # DrfMojoModel.unifyPreds
            ntrees = int(self.info.get("n_trees", 1))
            if self.nclasses == 1:
                return np.array([sums[0] / ntrees])
            if self.nclasses == 2:
                p0 = sums[0] / ntrees  # trees carry CLASS-0 probability
                return np.array([p0, 1.0 - p0])
            total = sums.sum()
            return sums / total if total > 0 else sums
        if dist == "bernoulli":
            f = sums[0] + init_f
            p1 = 1.0 / (1.0 + np.exp(-f))
            return np.array([1.0 - p1, p1])
        if self.nclasses > 2:
            e = np.exp(sums - sums.max())
            return e / e.sum()
        f = sums[0] + init_f
        return np.array([np.exp(f) if link == "log" else f])


def read_mojo(path: str) -> RefMojo:
    with zipfile.ZipFile(path) as z:
        return _read_entry(z, "")


def _read_entry(z: "zipfile.ZipFile", prefix: str) -> RefMojo:
    """Parse one model rooted at `prefix` inside the archive ("" for the
    top level; "models/<algo>/<key>/" for MultiModelMojoWriter
    sub-models)."""
    m = RefMojo()
    section = 0
    columns: List[str] = []
    domain_files: Dict[int, str] = {}
    for raw in z.read(prefix + "model.ini").decode().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[info]":
            section = 1
        elif line == "[columns]":
            section = 2
        elif line == "[domains]":
            section = 3
        elif section == 1:
            k, _, v = line.partition("=")
            m.info[k.strip()] = v.strip()
        elif section == 2:
            columns.append(line)
        elif section == 3:
            ci, _, rest = line.partition(":")
            # '<col>: <n_elements> <file>' (count optional for
            # tolerance with older writers)
            toks = rest.split()
            domain_files[int(ci)] = toks[-1]
    m.columns = columns
    for ci, fname in domain_files.items():
        m.domains[ci] = z.read(
            f"{prefix}domains/{fname}").decode().splitlines()
    K = int(m.info.get("n_trees_per_class", 1))
    ntrees = int(m.info.get("n_trees", 0))
    for c in range(K):
        m.trees.append([
            z.read(f"{prefix}trees/t{c:02d}_{t:03d}.bin")
            for t in range(ntrees)
        ])
    if m.info.get("algo") == "coxph":
        m.x_mean_cat = np.frombuffer(z.read(prefix + "x_mean_cat"), ">f8")
        m.x_mean_num = np.frombuffer(z.read(prefix + "x_mean_num"), ">f8")
    if m.info.get("algo") == "pca":
        ncoefs = int(m.info["eigenvector_size"])
        kcomp = int(m.info["k"])
        m.eigenvectors = np.frombuffer(
            z.read(prefix + "eigenvectors_raw"), ">f8"
        ).reshape(ncoefs, kcomp)
    if m.info.get("algo") == "targetencoder":
        base = prefix + "feature_engineering/target_encoding"
        enc: Dict[str, Dict[int, tuple]] = {}
        cur = None
        for line in z.read(f"{base}/encoding_map.ini").decode() \
                .splitlines():
            line = line.strip()
            if line.startswith("[") and line.endswith("]"):
                cur = line[1:-1]
                enc[cur] = {}
            elif line and cur is not None:
                k, _, v = line.partition("=")
                parts = v.split()
                enc[cur][int(k)] = (float(parts[0]), float(parts[1]))
        m.te_encodings = enc
        order = []
        in_from = False
        for line in z.read(f"{base}/input_encoding_columns_map.ini") \
                .decode().splitlines():
            line = line.strip()
            if line == "[from]":
                in_from = True
            elif line.startswith("["):
                in_from = False
            elif line and in_from:
                order.append(line)
        m.te_columns = order or list(enc)
    if m.info.get("algo") == "word2vec":
        words = [
            _unescape_vocab_word(w)
            for w in z.read(prefix + "vocabulary").decode().split("\n")
            if w != ""
        ]
        vocab_size = int(m.info["vocab_size"])
        if len(words) != vocab_size:
            raise ValueError(
                f"corrupted vocabulary: {len(words)} words != "
                f"vocab_size {vocab_size}")
        vecs = np.frombuffer(
            z.read(prefix + "vectors"), dtype=">f4").reshape(
            vocab_size, int(m.info["vec_size"])
        )
        m.word_vectors = dict(zip(words, np.asarray(vecs, np.float32)))
    if m.info.get("algo") == "gam":
        # GamMojoReader: per-smoother knots / zTranspose / _binvD blobs
        # (big-endian f64) + the gam column-name text files
        nks = _parse_jarr(m.info["num_knots_sorted"], int)
        m.gam_columns = z.read(
            prefix + "gam_columns_sorted").decode().split()
        kb = z.read(prefix + "knots")
        zb = z.read(prefix + "zTranspose")
        bb = z.read(prefix + "_binvD")
        m.gam_knots, m.gam_zt, m.gam_binvd = [], [], []
        ko = zo = bo = 0
        for k in nks:
            m.gam_knots.append(np.frombuffer(
                kb, ">f8", count=k, offset=ko).copy())
            ko += 8 * k
            m.gam_zt.append(np.frombuffer(
                zb, ">f8", count=(k - 1) * k, offset=zo
            ).reshape(k - 1, k).copy())
            zo += 8 * (k - 1) * k
            m.gam_binvd.append(np.frombuffer(
                bb, ">f8", count=(k - 2) * k, offset=bo
            ).reshape(k - 2, k).copy())
            bo += 8 * (k - 2) * k
    if m.info.get("algo") == "pipeline":
        # MojoPipelineReader: sub-models by submodel_dir_i, generated
        # columns bound to (model alias, prediction index)
        m.pipeline_models = {}
        for i in range(int(m.info["submodel_count"])):
            key = m.info[f"submodel_key_{i}"]
            subdir = m.info[f"submodel_dir_{i}"]
            m.pipeline_models[key] = _read_entry(z, prefix + subdir)
        m.pipeline_gen = []
        for i in range(int(m.info.get("generated_column_count", 0))):
            m.pipeline_gen.append((
                m.info[f"generated_column_name_{i}"],
                m.info[f"generated_column_model_{i}"],
                int(m.info[f"generated_column_index_{i}"]),
            ))
        m.pipeline_main = m.info["main_model"]
    if m.info.get("algo") == "stackedensemble":
        # sub-models live under models/<algo>/<key>/ (MultiModelMojoWriter)
        def find_prefix(key: str) -> str:
            suffix = f"/{key}/model.ini"
            for nm in z.namelist():
                if nm.startswith(prefix + "models/") and nm.endswith(suffix):
                    return nm[: -len("model.ini")]
            raise ValueError(f"sub-model {key!r} missing from archive")

        m.metalearner = _read_entry(z, find_prefix(m.info["metalearner"]))
        m.base_models = []
        for i in range(int(m.info["base_models_num"])):
            key = m.info.get(f"base_model{i}")
            m.base_models.append(
                _read_entry(z, find_prefix(key)) if key else None)
    return m
