#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``h2o3_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--rows 2000000] [--out result.json]
                          [--parent OLD_CHECKOUT]

Run from the root of a checkout. Phases, each of which must pass:

1. a CUDA card is present (else exit 2); print its name and power limit;
2. build the three histogram kernels from ``h2o3_tpu_torch/csrc`` with
   nvcc, one nvcc per source, started together;
3. hold the node-matmul kernel (``hist_nodematmul``) against its plain
   PyTorch version on the card at the shapes the fits give it (N rows x 28
   features, 257 and 21 bins, 1 to 64 nodes, 11 features, 30% inactive
   rows with one empty node, with and without a count weight), and at the
   wide levels whose per-warp histogram did not fit shared memory before
   the kernel tiled each level's cells across warps (64 nodes x 303 bins,
   16 x 1,209, 64 x 513): rtol 1e-5 / atol 1e-4 on Σg/Σh, counts exact,
   empty node exactly zero, two calls bit-identical and so the build for
   the padded node count; time the kernel, the plain version and one
   ``index_add_`` call; and at 16 and 64 nodes x 257 bins, where it tiles
   each level's cells across warps, bit-identical to the factorized kernel;
4. the same for the sorted per-node kernel (``hist_sorted``) at DRF's wide
   levels (N x 28, 21 bins, 128 / 1024 / 2048 nodes; 257 bins at 512
   nodes; 11 features at 300 nodes with a count weight; 30% inactive rows,
   empty nodes in the middle of the range), given the row-major copy of
   the codes a fit makes once (its time apart); there also bit-identical
   to its plain version that keeps the kernel's float order
   (``ordered_bits``), its prep and gather kernels equal to their plain
   twins, and its time split into the prep (the sort), the gather, pass 1
   and pass 2; and against the node-matmul kernel at 64 nodes;
5. the same for the factorized kernel (``hist_factorized``) at the levels
   the monotone XGBoost path below sends it (N x 28, 257 bins, 1 node with
   a count weight, 2, 4, 8 and 16 nodes, and 8 nodes at 60% inactive rows;
   21 bins at 8 nodes; 11 features at 5 nodes with a count weight), timing
   the node-matmul kernel at each shape too; there its output and the
   node-matmul kernel's are bit-identical to their ordered plain version
   (``hist_chunked_ordered_reference``), its time is split into pass 1
   and pass 2, and with ``--parent`` another checkout's factorized kernel
   (its own wrapper, plan and source) is held to the same bits and timed
   in turn; and against the node-matmul kernel on one level;
6. the port's ``jax.random`` streams (``util/jrandom.py``) give on the card
   the bits they give on the CPU;
7. the fit's binning on the card (``apply_bins_device``) gives the host
   ``apply_bins``'s codes, ``torch.equal`` (transposed), at N x 28 for 256,
   20 and 512 bins and on a 100,000-row adversarial frame (5% NaN, +-inf,
   -0.0, values at and one float32 step off an edge, a 3-value column with
   +inf-padded edges, an all-NaN column); the host's seconds and the
   card's milliseconds, upload included;
8. train XGBoost (``--base-trees`` trees, defaults: depth 6, 256 bins) on a
   HIGGS-shaped frame (N x 28 numeric, binary response), predict, score;
   check that each kernel ran exactly once per level it serves, that AUC
   is finite and above 0.5, that the same fit with the plain histogram on
   the card gives the same trees (or AUC within 1e-4), and that a small
   fit on the card gives the same trees as on the CPU. Every fit of this
   and the later phases checks its device frame cache lookup exactly: the
   hits and misses its key gives (frame, bins, seed, device), and the
   entry it used lies on its device; each fit record carries them and the
   parts of its fit time (``setup_s``, ``prep_s`` with ``bins_s`` and
   ``place_s``, ``boost_s``, ``metrics_s``);
9. the same for GBM (``--base-trees`` trees, defaults: depth 5, 20 bins);
10. the same for DRF at its defaults but for its trees (``--drf-trees``;
   depth 12, 20 bins, sample_rate 0.632, mtries sqrt(F)): 8 node-matmul
   and 4 sorted launches per tree; with GBM's bins and seed it hits GBM's
   cache entry, and the entry grows by the row-major codes its first
   sorted level makes there, once;
11. the same for XGBoost at its defaults (``--trees`` trees) with
   ``monotone_constraints`` on x2 and x3, each in the direction of the
   column's correlation with the response (the direction a user who knows
   the data would set; against it, no split on the column is allowed and
   the sweep below would check nothing), and ``hist_fact_max_kc=32``: its
   built levels hold 1, 1, 2, 4, 8 and 16 nodes (subtraction), padded 8, 8,
   8, 8, 8 and 64, so 5 factorized and 1 node-matmul launches per tree;
   then continue it from its checkpoint to twice the trees: the same
   launches per new tree, the same trees as one fit of twice the trees (or
   AUC within 1e-4), and every one of 1,000 rows' margins exactly monotone,
   in the constraint's direction, as x2 or x3 is swept over 20 values, and
   some rows' margins moving;
12. XGBoost at ``nbins=512`` and ``max_depth=8`` (``--wide-trees`` trees)
   on the first ``--wide-rows`` rows of the frame: its built levels hold 1
   to 64 nodes at 513 bins, all on the node-matmul kernel (8 launches per
   tree), checked as in 8 but for the small fit on the CPU;
13. the bf16 operand mode (``dtype="bf16"``: g, h and the count weight
   rounded to bf16, summed in float, counts exact; the JAX package's default
   on its own chip) at one level of each kernel the bf16 fits build (N x 28:
   B1 at 257 bins x 16 nodes, its tile kernel, and 21 x 8, its warp kernel;
   B2 at 21 x 1,024; B3 at 257 x 8), on the f32 checks' inputs: held to the
   plain version in bf16 as in 3-5 (B2 bit-identical to its ordered plain
   version), different from the f32 output, timed in turn with the f32
   call; and B3 in bf16 bit-identical to B1 in bf16;
14. XGBoost (``--bf16-trees`` trees: 6 B1 launches each), DRF
   (``--bf16-drf-trees``: 8 B1 and 4 B2 each) and phase 11's monotone
   XGBoost (``--bf16-trees``: 1 B1 and 5 B3 each) with
   ``hist_dtype="bf16"``, checked as in 8 but for the small fit on the CPU,
   the monotone one also with phase 11's sweep; each prints its AUC beside
   that of its twin in f32, trained after it; the bf16 DRF fit hits GBM's
   entry and makes no second row-major copy;
15. XGBoost cross-validation (``nfolds=3``, random folds, ``--cv-trees``
   trees) on the first ``--wide-rows`` rows: the CV AUC finite and above
   0.5, 6 node-matmul launches per tree of each of the 4 fits, each fold
   frame a cache miss, and equal fold trees (or CV AUC within 1e-4) with
   the plain histogram on the card; then no cache entry was evicted;
16. the scoring surface on phase 8's XGBoost model (and phase 10's DRF
   model for the MOJO): ``predict_raw_batched`` on [frame, frame, its
   first 300,000 rows], each caller's raw scores ``np.array_equal`` to a
   pass over its frame alone, timed against the three passes;
   ``reset_threshold`` moves labels; ``make_metrics`` on the raw scores
   equals ``model_performance``; ``predict_contributions`` (TreeSHAP on the
   host, the training frame as background) on the first 2,000 rows, each
   row summing to ``predict_margin`` at rtol 1e-5 / atol 1e-5, in rows/s;
   ``variable_importances`` summing to 1; ``save_model``/``load_model`` on
   the card giving the same bits on 300,000 rows, and ``dumps_model`` the
   same bytes twice; the XGBoost and DRF MOJOs scored by the numpy
   ``genmodel`` on 10,000 rows at rtol 1e-4 / atol 1e-5; the C POJO built
   with the host's C compiler against ``predict`` at rtol 1e-5 / atol 1e-6;
   the entry step (``h2o3_tpu_torch.entry``) on the card against the CPU's
   at atol 1e-6. It prints a ``{"surface": {...}}`` line with each time;
17. the GLM (``glm_phase``): binomial IRLSM at lambda 0 on the N x 28
   frame (coefficients finite) and again at lambda 1e-4 (its design a
   ``glm_design`` cache hit), L-BFGS at lambda 1e-4 within 1e-3 of that
   IRLSM fit, IRLSM on the first 200,000 rows on the card and on the CPU
   (coefficients rtol 1e-4, AUC within 1e-4, equal iterations), a gaussian
   lambda search (10 lambdas, alpha 0.5: ADMM) on the frame's logit plus
   noise whose training deviance never rises along the path, multinomial
   IRLSM and L-BFGS at lambda 1e-3 on an MNIST-shaped frame
   (``--mnist-rows`` x 784 in [0, 1], 10% of the columns zero, 10 classes;
   the L-BFGS fit below the constant predictor's logloss), a
   prostate-shaped binomial (380 rows, ``standardize=False``, p-values,
   3-fold CV) on the card and the CPU (coefficients rtol 1e-3, p-values
   1e-2, beside the CPU's own spread on permuted rows), and the binomial
   model's MOJO (numpy ``genmodel``) and C POJO against ``predict`` on
   10,000 rows (1e-6). Each fit prints ``train_s``, its Gram passes and
   their mean ms (CUDA events), its iterations and its GLM cache hits and
   misses, and the phase a ``{"glm": ...}`` line;
18. DeepLearning (``deeplearning_phase``) on the MNIST-shaped frame at
   hidden [200, 200], rectifier, mini-batch 256: the init and the first
   step's dropout masks bit-identical to the CPU's, one ADADELTA step of
   256 rows within 1e-5 of the CPU's, a ``--dl-epochs`` ADADELTA fit
   (logloss below the constant predictor's, misclassification below
   0.5), continued from its checkpoint by one epoch and equal to a
   straight fit (bit for bit, or each weight within 1e-6, said in the
   line), a dropout epoch (input 0.2, hidden 0.5), an SGD epoch with the
   momentum ramp 0.5 -> 0.99, an autoencoder (hidden [14]) on 100,000
   rows of the N x 28 frame with a finite ``anomaly``, and the MOJO
   against ``predict`` (1e-5); samples/s and ms per step of each epoch,
   ``predict_s``, and a ``{"deeplearning": ...}`` line. No histogram
   kernel launches in 17 and 18;
19. AutoML (``automl_phase``) on an airlines-shaped frame
   (``--air-rows`` rows of the airlines demo frame's columns: 8 numeric,
   UniqueCarrier with 20 levels, Origin and Dest with 300, NAs, the
   IsDepDelayed response): ``AutoML(max_models=10, nfolds=3, seed=1,
   preprocessing=["target_encoding"])`` with its default plan unchanged
   (XGBoost, GLM, DRF, GBM, DeepLearning, XGBoost, the random GBM grid,
   exploitation, both stacked ensembles): no failed step, failed target
   encoding or failed grid cell (the run logs and carries on by design, so
   the phase reads the event log and every grid), every planned step built,
   every model and encoder on the card, the leader's metric finite and
   above 0.5 with both ensembles on the leaderboard, the leader scoring the
   raw frame through its encoder as the encoded frame, the leader and the
   best-of-family ensemble through save and load on the card with the same
   prediction bits, and B1 and B2 launched; then the same AutoML with
   ``include_algos=["xgboost", "gbm", "glm", "stackedensemble"]``,
   ``max_models=3``, ``nfolds=2`` on the first 10,000 rows on the card and
   twice on the CPU, with the card's level flow and with its own (the same
   steps in the same order; each CV AUC within 1e-4 of the nearer CPU
   run's or, where the CPU's two runs lie further apart, within ten times
   their distance; leaderboard ranks equal where the gap exceeds that);
   then a
   4-cell GBM
   grid with ``parallelism=2`` and with 1 (equal trees and leaves). It
   prints each step's CV AUC, ``train_s`` and seconds, the leaderboard, the
   leader's predict rows/s, the device frame cache's hits, misses and
   evictions and the kernel launches of the run, in an ``{"automl": ...}``
   line;
20. KMeans, PCA and SVD, GLRM, NaiveBayes and both isolation forests
   (``breadth_phase``) at the full width of their frames, fitted on every
   row and scored on 200,000 (the isolation forest on every row): on the
   N x 28 features with 8 cluster centres added (``clustered_frame``)
   KMeans k=10 (``plus_plus``, 10 iterations; ``estimate_k`` up to 10); on
   the N x 28 frame PCA k=10 standardized, SVD nv=10, the isolation forest
   at its defaults (50 trees, samples of 256, depth 8) and the extended one
   (100 trees) at extension levels 0 and 27; on the MNIST-shaped frame PCA
   k=50 demeaned, and on it with 3% of its cells NA GLRM k=10 with
   quadratic loss (exact ALS) and with huber loss and l1 on X (the
   proximal line search, 10 iterations: cut from 20 for the phase's time,
   PERF.md section 4); on 1,000,000 airlines-shaped rows NaiveBayes with
   ``laplace=1``. Each fit prints ``train_s``, predict rows/s, its
   iterations, the device memory peak and its headline results (WSS, pve,
   the objective, anomaly scores, AUC); the designs' ``kmeans_x`` and ``pca_x`` cache hits and
   misses are exact. Card against CPU on the first 200,000 rows (the
   MNIST-shaped frame whole): the forests' trees equal, the isolation
   forest's path lengths ``torch.equal``, the extended forest's
   ``mean_length`` rtol 1e-5 (the rows outside counted: none at level 0,
   at most 20 at level 27, each within one tree's longest path over the
   tree count), KMeans ``tot_withinss`` rtol 1e-4 (``estimate_k``'s k
   equal), PCA and SVD eigenvalues rtol 1e-4, GLRM objectives rtol 1e-3,
   NaiveBayes tables equal; the KMeans, PCA, isolation-forest and NaiveBayes MOJOs through
   the port's ``genmodel`` against ``predict`` (rtol 1e-6; PCA also atol
   1e-5), and every model saved and loaded on the card with the same bits.
   It prints a ``{"breadth": ...}`` line and launches no histogram kernel;
21. GAM, CoxPH, PSVM and Word2Vec (``breadth2_phase``) at full width: on
   the N x 28 frame a binomial GAM with x0, x1, x2 as cubic regression
   splines, [x3, x4] as one thin-plate smoother and x5 as a monotone
   I-spline, at lambda 0 and on the ADMM path (alpha 0.5, lambda 1e-4,
   its design a ``gam_design`` cache hit), a gaussian GAM on the frame's
   logit with M-splines, and a cubic-regression GAM on the first 200,000
   rows whose C POJO, built with the host's C compiler, scores 10,000 rows
   inside the knots as ``predict`` does (rtol 1e-10); CoxPH with efron
   and breslow ties and a left-truncated fit on 1,000,000 survival
   rows (``synth_survival``: 28 covariates, proportional hazards, about
   30% censored, times rounded to 0.01); PSVM at its defaults on the frame's first 200,000 rows; and
   Word2Vec at its defaults twice on a 400,000-token corpus
   (``synth_corpus``: Zipf over 50,000 words, sentences of 20), the two
   runs' vectors equal bit for bit. Each fit prints ``train_s``, predict
   rows/s on 200,000 rows, its iterations, the device memory peak and its
   headline results. Card against CPU: the GAM on 200,000 rows
   (coefficients rtol 1e-4, atol 1e-6 times the largest coefficient's
   size; iterations equal), CoxPH on 100,000 rows (coefficients rtol
   1e-3, log-likelihood rtol 1e-5), PSVM on 20,000 rows (the support sets
   equal on every row whose alpha lies 1e-5 or more from ``sv_threshold``
   on both devices, decision values atol 1e-4), Word2Vec on 100,000 tokens for one epoch (vectors
   rtol 1e-4 / atol 1e-5); the MOJO export of each model raises the JAX
   package's ``ValueError``, and one model of each family is saved and
   loaded on the card with the same bits. It prints a ``{"breadth2": ...}``
   line and launches no histogram kernel;
22. Aggregator, RuleFit, segment models, Generic, Assembly with the scoring
   pipeline, and the reference-format MOJO (``breadth3_phase``): the
   Aggregator at its defaults on the first 200,000 rows of the N x 28
   features (cut from N for the script's time; counts summing to
   N, distinct exemplar rows, an output frame with ``counts`` and every
   predictor); RuleFit at its defaults (GBM rules of length 3 from 50
   trees, ``rules_and_linear``) on the frame's first 100,000 rows (cut
   from 200,000 for the phase's time), then
   with DRF rules, each fit launching B1 once per level of every tree of
   its ensembles and nothing else; one GBM per ``UniqueCarrier`` segment
   (20 levels and the NA segment) of 1,000,000 airlines-shaped rows (10
   trees, cut from GBM's 50 for the phase's time), on four worker threads
   and serially, every status ``succeeded``, the threaded trees equal to
   the serial ones bit for bit and the serial run's launches those its
   trees imply; one segment's GBM through its MOJO and ``import_mojo``
   against its ``predict`` on 200,000 rows (rtol 1e-4, atol 1e-5); an
   Assembly (``log1p`` of Distance, CRSArrTime - CRSDepTime, a column
   selection) on 200,000 raw rows, a GBM (10 trees) on its output and
   their ``ScoringPipeline`` through ``to_bytes``/``from_bytes``, whose
   ``transform`` of the raw rows scores as ``predict`` on the assembled
   rows (rtol 1e-4, atol 1e-5; labels part only at the threshold), a
   transform-only pipeline equal to ``Assembly.fit`` bit for bit and
   ``to_java`` writing each output once; ``models/mojo_ref.py``'s
   ``write_mojo`` of that GBM, of RuleFit's DRF ensemble and of its inner
   GLM, ``read_mojo`` and ``score0`` on 2,000 rows against the card's
   predictions (rtol 1e-4, atol 1e-5); card against CPU (the CPU's trees
   with the card's subtraction): RuleFit on 20,000 rows (the same rules,
   coefficients rtol 1e-4 / atol 1e-4 times their largest size, at least
   1, as the LASSO stops at ``beta_epsilon`` 1e-4; AUC within 1e-4) and
   the segment GBMs on 100,000 rows (each segment's AUC within 1e-4
   where its trees split alike on both devices; each segment whose trees
   part, at ties, fitted again on the card with its gradients, every
   level's B1 histogram bit for bit and its split search checked against
   the CPU, ``replay_parted_segments``); and ``dispatch_probe``, the cost
   of a small call that lets go of the GIL, from one and four threads. It
   prints each part's seconds, device frame cache hits and misses and
   device memory peak in a ``{"breadth3": ...}`` line;
23. the Rapids engine (``rapids_phase``) with ``Session(device="cuda")``
   on the N x 28 frame and 2,000,000 airlines-shaped rows, each step
   against its plain version (the interpreter with ``fusion=False``, the
   host sort, merge and group-by under ``host_paths``): five fused
   pipelines over the HIGGS columns (``ifelse`` over comparisons, ``%%``
   and ``%/%``, ``sqrt(abs(.))`` over a ``cols`` selection, ``round`` under
   a trailing ``sum``, ``floor``, ``sign``, ``trunc``, ``is.na``) bit for bit
   (NaN payloads aside), each warm repeat planning nothing and uploading
   nothing (a ``frame_table`` hit); every fusible prim's emit on the card
   against numpy on the special values and 1,000,000 wide ones a side (a
   prim that fuses on the card must not part; the list of prims fused on
   the card is printed) and its region against the interpreter; ``sort``
   by [Origin, Distance], Distance descending, in the host lexsort's
   order; ``merge`` ``all_left`` with a 300-row Origin lookup, every
   column equal; ``GB`` by [Origin, Dest] with nrow, mean, sum, min, max,
   sd and var of Distance (NAs removed): the same bits twice, keys and
   counts equal to the host engine's, min and max within one float32
   rounding of the centred value, the moments at the JAX package's
   device-against-host tolerances, and the segment reduction's counts,
   min and max equal on the card and on CPU tensors; ``quantiles`` of a
   column with NaNs at 0, 0.001, 0.5, 0.999 and 1, card and CPU bit for bit;
   ``x`` of N x 28 by 28 x 4 against float64 numpy (each entry within 1e-4
   of the size of its terms); rollups of every airlines column against
   ``map_reduce`` on the card (counts, min, max, zeros, ``is_int`` and the
   histogram exact, mean 1e-12, sigma 1e-10). It prints each step's card
   and host seconds and the device memory peak in a ``{"rapids": ...}``
   line and launches no histogram kernel;
24. the Rapids prims of ``search``, ``advmath``, ``strings``, ``times`` and
   ``models`` (``rapids_prims_phase``), host numpy as in the JAX package,
   each expression on ``Session(device="cuda")`` and on a CPU session
   with the same bits, and where a region fused on the card feeds the prim
   against the interpreter too: ``which``, ``which.max``, ``which.min``
   and ``match`` fed by fused comparisons on the 2,000,000 airlines rows;
   ``cor`` and ``var`` of the 28 HIGGS columns (against ``np.corrcoef``
   and ``np.cov``), ``skewness``, ``kurtosis``, ``hist``, ``quantile`` and
   ``difflag1`` of one, ``table`` and ``unique`` of Origin and Dest,
   ``h2o.impute`` of Distance by Origin, the k-fold columns, ``h2o.runif``
   and ``h2o.random_stratified_split`` at 2,000,000 rows, ``distance``
   between 2,000 and 100 rows of 28 in all four measures, ``tf-idf`` and
   ``isax`` on 20,000 rows; the string prims on the 200,000-row STR
   columns ``as.character`` makes of Origin and Dest (``entropy``,
   ``countmatches``, ``tokenize``, ``num_valid_substrings`` and
   ``strDistance``, which loop over characters in Python, on 20,000) and
   on the CAT Origin (its domain mapped, and re-coded where ``substring``
   collapses levels); ``mktime`` of 200,000 airlines rows (exact against
   numpy's datetime64), the UTC fields, ``as.Date`` of the same stamps as
   strings, one America/New_York round on 20,000 rows and back to UTC;
   ``perfectAUC`` of the XGBoost model's predictions, its threshold reset,
   ``segment_models_as_frame`` of phase 22's segment run, and
   ``PermutationVarImp`` (logloss, 100,000 sampled rows) on the card and
   on the CPU (each variable within ``PVI_ATOL``). It prints each step's
   card and CPU seconds, the prims run and the device memory peak in a
   ``{"rapids_prims": ...}`` line and launches no histogram kernel (but
   B1 for its own two-segment fit, made only where no segment run is left
   in the DKV, counted on the kernels line);
25. row sharding over ``torch.distributed`` (``mesh_phase``, the port's
   ``parallel/mesh.py``) in spawned ranks on this card: (a) one rank with
   NCCL at world size 1 fits phase 8's XGBoost through ``.train()`` with
   the group live, its trees and predictions bit for bit phase 8's, and
   prints its collectives, while ``entry.dryrun_multichip(1,
   device="cuda")`` runs beside it; then (b) two gloo ranks sharing ``cuda:0`` (host-staged) fit the same
   XGBoost (the same trees as phase 8, or AUC within 1e-4), build the
   merged root histogram (counts exact, sums at rtol 1e-5 / atol 1e-4 of
   one build over every row), fit a 5-tree DRF (B2 at levels 8-11,
   sharded), sort 2,000,000 airlines-shaped rows by [Origin, Dest] with
   the sample sort (the host lexsort's order bit for bit) and group them
   (counts exact), and run one sharded GLM Gram pass (each entry within
   1e-5 of the size of its terms of one pass over every row); both ranks'
   trees, gathered predictions, orders, groups and Grams the same bits;
   each fit's launches exact. It prints the seconds of each part, merges
   per fit, ms per merge (CUDA events), bytes gathered per level and the
   device memory peak in a ``{"mesh": ...}`` line with the card's name
   and power limit;
26. with ``--profile``, one more XGBoost, DRF and monotone XGBoost fit
   each under ``torch.profiler``: device time by kernel, and the device's
   idle share of the fit.

It prints the whole run's seconds, one ``{"kernels": [...]}`` line (each
kernel's f32 record and, under ``"bf16"``, its bf16 one; its launches are
those of phases 8-15, of phase 19's main AutoML run, of phase 22's
RuleFit, serial segment and pipeline fits, of phase 24's segment fit
where it makes one and of phase 25's ranks' fits; phases 16-18, 20, 21
and 23 launch no histogram kernel), then
the card's name and power limit, then as the last line ``{"ok": true,
"device": {...}}``. Any failure exits nonzero before those lines. Imports
nothing of JAX. Matmuls stay true float32: the port never enables TF32,
and phase 17 checks that it is off.
"""

from __future__ import annotations

import argparse
import json
import os
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
    """HIGGS-shaped binary data: N(0,1) features, a logistic response, and
    the logit it was drawn from."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    w = rng.normal(size=n_feat) / np.sqrt(n_feat)
    logit = X @ w + 0.5 * X[:, 0] * X[:, 1]
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return X, y, logit


def clustered_frame(X, seed, k=8):
    """The HIGGS-shaped features with one of ``k`` cluster centres added to
    each row: centres N(0, 3^2) a coordinate, shares drawn from
    Dirichlet(2). Returns a frame of the features alone."""
    from h2o3_tpu_torch import ColType, Column, Frame

    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(k, X.shape[1])).astype(np.float32)
    share = rng.dirichlet(np.full(k, 2.0))
    B = X + centres[rng.choice(k, len(X), p=share)]
    return Frame([Column(f"x{j}", B[:, j], ColType.NUM) for j in range(B.shape[1])])


def blank_cells(X, seed, share=0.03):
    """A copy of ``X`` with ``share`` of its cells NA, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    X = X.copy()
    X[rng.random(X.shape, dtype=np.float32) < share] = np.nan
    return X


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


def kernel_fns(kernel: str):
    """(wrapper, plain version) of one of the port's histogram kernels."""
    from h2o3_tpu_torch.ops import cuda_factorized_histogram as cf
    from h2o3_tpu_torch.ops import cuda_histogram as ch
    from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs

    return {
        "hist_nodematmul": (ch.hist_nodematmul, ch.hist_nodematmul_reference),
        "hist_sorted": (cs.hist_sorted, cs.hist_sorted_reference),
        "hist_factorized": (cf.hist_factorized, cf.hist_factorized_reference),
    }[kernel]


def kernel_inputs(n, n_feat, n_bins1, k, weighted, seed, dev, empty_run=False,
                  inactive=0.3):
    """Random level inputs: ``inactive`` of the rows inactive (30%; 60% is
    a level past the root under subtraction), node k // 2 empty, and with
    ``empty_run`` also nodes k // 3 .. k // 3 + 4. Returns (args, rw,
    empty nodes)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    bins_fm = torch.randint(0, n_bins1, (n_feat, n), generator=gen,
                            device=dev, dtype=torch.int32)
    nodes = torch.randint(0, k, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    empty = [k // 2] if k >= 3 else []
    if empty:
        nodes[nodes == empty[0]] = empty[0] + 1
    if empty_run and k >= 16:
        lo = k // 3
        nodes[(nodes >= lo) & (nodes < lo + 5)] = lo + 5
        empty += list(range(lo, lo + 5))
    nodes[torch.rand(n, generator=gen, device=dev) < inactive] = -1
    g = torch.rand(n, generator=gen, device=dev) * 2 - 1
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    rw = (torch.randint(1, 4, (n,), generator=gen, device=dev).float()
          if weighted else None)
    return (bins_fm, nodes, g, h, k, n_bins1), rw, empty


def kernel_case(kernel, n, n_feat, n_bins1, k, weighted, seed, dev, dtype="f32",
                inactive=0.3, parent=None):
    """One kernel-vs-plain check of ``kernel`` on k nodes in operand mode
    ``dtype`` with ``inactive`` of the rows inactive; returns its record.
    In bf16 it also checks that the output differs from the f32 output on
    the same inputs (the mode reached the kernel) and times the f32 call
    beside the bf16 one. ``parent``: another checkout's factorized wrapper
    (``parent_factorized``) to time in turn with this one."""
    import torch

    from h2o3_tpu_torch.ops.cuda_build import round_operand
    from h2o3_tpu_torch.ops.histogram import pad_nodes

    wrapper, reference = kernel_fns(kernel)
    args, rw, empty = kernel_inputs(n, n_feat, n_bins1, k, weighted, seed, dev,
                                    empty_run=kernel == "hist_sorted",
                                    inactive=inactive)
    bins_fm, nodes, g, h, _, _ = args
    kw = {}
    if kernel == "hist_sorted":
        # a fit makes the row-major copy of its codes once, for every level
        from h2o3_tpu_torch.ops.cuda_sorted_histogram import row_major_codes
        kw["codes_rm"] = row_major_codes(bins_fm, n_bins1)

    kw["dtype"] = dtype
    a = wrapper(*args, rw=rw, **kw)
    b = wrapper(*args, rw=rw, **kw)
    ref = reference(*args, rw=rw, dtype=dtype)
    torch.cuda.synchronize()
    name = (f"{kernel} {dtype} N={n} F={n_feat} B1={n_bins1} K={k}"
            f"{' rw' if weighted else ''}"
            f"{f' inactive={inactive}' if inactive != 0.3 else ''}")
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two kernel calls differ")
    k_pad = pad_nodes(k)
    if kernel != "hist_sorted" and not torch.equal(
            wrapper(bins_fm, nodes, g, h, k_pad, n_bins1, rw=rw, dtype=dtype)[:k], a):
        raise AssertionError(f"{name}: the build for {k_pad} padded nodes differs")
    f32_kw = dict(kw, dtype="f32")
    if dtype != "f32" and torch.equal(a, wrapper(*args, rw=rw, **f32_kw)):
        raise AssertionError(f"{name}: the same output as in f32")
    if not torch.equal(a[..., 2], ref[..., 2]):
        raise AssertionError(f"{name}: counts differ from the plain version")
    if empty and not torch.all(a[empty] == 0):
        raise AssertionError(f"{name}: empty nodes {empty} are not exactly zero")
    if not torch.allclose(a, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError(
            f"{name}: max |kernel - plain| {(a - ref).abs().max().item()} "
            f"outside rtol {RTOL} / atol {ATOL}")
    max_err = (a - ref).abs().max().item()
    extra = {}
    if kernel == "hist_sorted":
        extra = sorted_checks(name, args, rw, kw["codes_rm"], a, dtype)
    if kernel == "hist_factorized":
        extra = factorized_checks(name, args, rw, a, dtype, parent)

    ms = time_ms(lambda: wrapper(*args, rw=rw, **kw), reps=10)
    if dtype != "f32":  # the f32 call at this shape, in turn with the bf16 one
        extra["f32_ms"] = time_ms(lambda: wrapper(*args, rw=rw, **f32_kw), reps=10)
        extra["ms_again"] = time_ms(lambda: wrapper(*args, rw=rw, **kw), reps=10)
    plain_ms = time_ms(lambda: reference(*args, rw=rw, dtype=dtype), reps=3)
    # the one PyTorch call computing the same function: index_add_ of the
    # [N*F, 3] masked (g, h, w) rows (in bf16, the rounded values) at the
    # flat (node, feature, bin) index
    valid = nodes >= 0
    node0 = torch.where(valid, nodes, 0).long()
    flat = ((node0[None, :] * n_feat + torch.arange(n_feat, device=dev)[:, None])
            * n_bins1 + bins_fm.long()).reshape(-1)
    wv = valid.float()
    cw = wv if rw is None else wv * round_operand(rw, dtype)
    src = torch.stack([round_operand(g, dtype) * wv, round_operand(h, dtype) * wv, cw],
                      dim=1)[None].expand(n_feat, n, 3).reshape(-1, 3)
    lib_out = torch.zeros(k * n_feat * n_bins1, 3, device=dev)
    library_ms = time_ms(lambda: lib_out.zero_().index_add_(0, flat, src), reps=3)
    del flat, src, lib_out
    # the node-matmul kernel on the same level, to compare the contractions
    b1_ms = (time_ms(lambda: kernel_fns("hist_nodematmul")[0](*args, rw=rw, dtype=dtype),
                     reps=10)
             if kernel == "hist_factorized" else None)

    n_active = int(valid.sum().item())
    out_bytes = 4 * k * n_feat * n_bins1 * 3
    ops_ms = 3 * n_active * n_feat / FP32_OPS_PER_S * 1e3

    def bound(code_bytes):
        # each row's node id; an active row's codes, g, h (and rw), read as
        # float32 in both modes; the output
        in_bytes = 4 * n + n_active * (code_bytes * n_feat + 8 + (4 if weighted else 0))
        return (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3

    # the sorted kernel's timed call reads the narrow codes of codes_rm
    bytes_ms = bound(kw["codes_rm"].element_size() if kernel == "hist_sorted" else 4)
    rec = {
        "kernel": kernel, "dtype": dtype, "case": name, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if kernel == "hist_sorted":  # with the TPU kernel's int32 codes
        rec["bound_ms_int32"] = max(bound(4), ops_ms)
    if b1_ms is not None:
        rec["hist_nodematmul_ms"] = b1_ms
    rec.update(extra)
    print(f"kernel check ok: {json.dumps(rec)}", flush=True)
    return rec


#: the sorted kernel's launches, by the name of their CUDA kernel
SORTED_KERNELS = {"sorted_gather_kernel": "gather_ms",
                  "sorted_partial_kernel": "pass1_ms",
                  "sorted_reduce_kernel": "pass2_ms"}


def sorted_checks(name, args, rw, codes_rm, out, dtype):
    """The sorted kernel's own checks on one level in operand mode
    ``dtype``: its output is the bits of the plain version that keeps its
    float order; a call that makes its own ``codes_rm`` gives the same
    bits; the prep kernels lay the rows out as the plain prep does, and the
    gather kernel writes the active rows' codes and values of its plain
    twin. Also the time split."""
    import torch

    from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs

    bins_fm, nodes, g, h, k, n_bins1 = args
    if not torch.equal(out, cs.hist_sorted_ordered_reference(*args, rw=rw, dtype=dtype)):
        raise AssertionError(f"{name}: not the bits of the ordered plain version")
    if not torch.equal(out, cs.hist_sorted(*args, rw=rw, dtype=dtype)):
        raise AssertionError(f"{name}: a call without codes_rm differs")
    layout = cs.sorted_prep(nodes, k)
    plain = cs.sorted_prep_reference(nodes, k)
    for a, b, part in zip(layout, plain, layout._fields):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the prep's {part} differs from its plain twin")
    got = cs.gather_rows(codes_rm, layout, g, h, rw, bins_fm.shape[0], dtype)
    want = cs.gather_rows_reference(codes_rm, layout, g, h, rw, bins_fm.shape[0], dtype)
    m = int(layout.seg_off[-1])
    for part, a, b in zip(got._fields, got, want):
        if a is not None and b is not None:  # the active positions only
            a, b = a[..., :m], b[..., :m]
            if part == "codes":  # uint16 has no CUDA comparison
                a, b = a.int(), b.int()
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{name}: the gather's {part} differ from its plain twin")
    return {"ordered_bits": True, "prep_equal": True, "gather_equal": True,
            "codes_rm_ms": time_ms(lambda: cs.row_major_codes(bins_fm, n_bins1), 10),
            "split": sorted_split(args, rw, codes_rm, dtype)}


def sorted_split(args, rw, codes_rm, dtype, reps=10):
    """The sorted kernel's time per call in parts, ms: the prep (the sort
    and the offsets: CUDA events around ``sorted_prep``, and the device
    time of its kernels, the sort's radix passes among them), the
    allocation of the tile partials (events), the gather and each pass
    (device time by kernel name, from torch.profiler over ``reps`` calls),
    and the whole call (events), given the fit's ``codes_rm``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs

    bins_fm, nodes, _, _, k, n_bins1 = args
    n_feat, n = bins_fm.shape
    shape = (k + n // cs.TILE_ROWS, n_feat, 3, n_bins1)
    split = {
        "prep_ms": time_ms(lambda: cs.sorted_prep(nodes, k), reps),
        "partial_alloc_ms": time_ms(
            lambda: torch.empty(shape, device=nodes.device), reps),
        "call_ms": time_ms(lambda: cs.hist_sorted(*args, rw=rw, codes_rm=codes_rm,
                                                  dtype=dtype), reps),
    }
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cs.hist_sorted(*args, rw=rw, codes_rm=codes_rm, dtype=dtype)
        torch.cuda.synchronize()
    split["prep_device_ms"] = split["sort_device_ms"] = 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        part = [v for key, v in SORTED_KERNELS.items() if key in e.key]
        ms = e.self_device_time_total / 1e3 / reps
        if part:
            split[part[0]] = split.get(part[0], 0.0) + ms
            continue
        split["prep_device_ms"] += ms  # the sort and the offsets
        if "Radix" in e.key:
            split["sort_device_ms"] += ms
    return split


#: the factorized kernel's launches, by the name of their CUDA kernel
FACTORIZED_KERNELS = {"fact_direct_kernel": "pass1_ms",
                      "fact_staged_kernel": "pass1_ms",
                      "fact_reduce_kernel": "pass2_ms"}


def factorized_checks(name, args, rw, out, dtype, parent, reps=10):
    """The factorized kernel's own checks on one level in operand mode
    ``dtype``: its output and the node-matmul kernel's are the bits of
    their ordered plain version (``hist_chunked_ordered_reference``); the
    time split into pass 1 (for the staged kernel staging, compaction and
    the packs' adds, one kernel) and pass 2 (device time by kernel name,
    torch.profiler, ``reps`` calls); and with ``parent``, the other
    checkout's kernel's bits and its time in turn with this one's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h2o3_tpu_torch.ops import cuda_factorized_histogram as cf
    from h2o3_tpu_torch.ops import cuda_histogram as ch

    ordered = ch.hist_chunked_ordered_reference(*args, rw=rw, dtype=dtype)
    if not torch.equal(out, ordered):
        raise AssertionError(f"{name}: not the bits of the ordered plain version")
    if not torch.equal(ch.hist_nodematmul(*args, rw=rw, dtype=dtype), ordered):
        raise AssertionError(f"{name}: hist_nodematmul is not the ordered bits")
    del ordered
    bins_fm, _, _, _, k, n_bins1 = args
    plan = cf.launch_plan(bins_fm.shape[1], bins_fm.shape[0], k, n_bins1)
    rec = {"ordered_bits": True, "nodematmul_ordered_bits": True,
           "plan": plan._asdict()}
    split = {"call_ms": time_ms(lambda: cf.hist_factorized(*args, rw=rw, dtype=dtype), reps)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cf.hist_factorized(*args, rw=rw, dtype=dtype)
        torch.cuda.synchronize()
    split["other_device_ms"] = 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        part = [v for key, v in FACTORIZED_KERNELS.items() if key in e.key]
        ms = e.self_device_time_total / 1e3 / reps
        split[part[0] if part else "other_device_ms"] = \
            split.get(part[0] if part else "other_device_ms", 0.0) + ms
    rec["split"] = split
    if parent is not None:
        if not torch.equal(parent(*args, rw=rw, dtype=dtype), out):
            raise AssertionError(f"{name}: the other checkout's kernel gives other bits")
        turns = {"ms": [], "parent_ms": []}
        for _ in range(2):  # this kernel, the other one, in turn
            turns["ms"].append(time_ms(lambda: cf.hist_factorized(*args, rw=rw, dtype=dtype), reps))
            turns["parent_ms"].append(time_ms(lambda: parent(*args, rw=rw, dtype=dtype), reps))
        rec["in_turn"] = turns
    return rec


def parent_factorized(checkout):
    """The factorized wrapper ``hist_factorized`` of another checkout of
    this repository (``--parent``, e.g. a ``git archive`` of the parent
    commit), imported as that checkout's own ``h2o3_tpu_torch``: its plan,
    its binding and its kernel source, built into its own ``_build``. This
    process's package is put back afterwards; the returned function keeps
    the other package's modules."""
    import importlib
    from pathlib import Path

    root = Path(checkout).resolve()
    pkg = "h2o3_tpu_torch"

    def ours():
        return {k: m for k, m in sys.modules.items()
                if k == pkg or k.startswith(pkg + ".")}

    saved = ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module(pkg + ".ops.cuda_factorized_histogram")
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    if root not in Path(mod.__file__).resolve().parents:
        raise RuntimeError(f"--parent {checkout}: imported {mod.__file__}, not its own")
    return mod.hist_factorized


def cross_check(kernel, n, n_feat, n_bins1, k, seed, dev, dtype="f32"):
    """``kernel`` against the node-matmul kernel on one level both serve, in
    operand mode ``dtype``: counts exact, sums within the tolerance."""
    import torch

    wrapper = kernel_fns(kernel)[0]
    nodematmul = kernel_fns("hist_nodematmul")[0]
    args, rw, _ = kernel_inputs(n, n_feat, n_bins1, k, True, seed, dev, empty_run=True)
    a = wrapper(*args, rw=rw, dtype=dtype)
    b = nodematmul(*args, rw=rw, dtype=dtype)
    torch.cuda.synchronize()
    name = f"{kernel} vs hist_nodematmul {dtype} N={n} F={n_feat} B1={n_bins1} K={k} rw"
    if not torch.equal(a[..., 2], b[..., 2]):
        raise AssertionError(f"{name}: counts differ")
    if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max diff {(a - b).abs().max().item()}")
    rec = {"case": name, "max_abs_diff": (a - b).abs().max().item(),
           "bit_identical": bool(torch.equal(a, b))}
    print(f"cross check ok: {json.dumps(rec)}", flush=True)
    return rec


def jrandom_check(dev):
    """The port's jax.random streams give the same bits on the card as on
    the CPU: uniforms at the shapes a fit draws, and key splits computed as
    tensors on the card against the host's integer keys."""
    import torch

    from h2o3_tpu_torch.util import jrandom as jr

    n_checked = 0
    for seed in (0, 42, 2**31 + 3, -1):
        key = jr.fold_in(jr.PRNGKey(seed), 7)
        for shape in ((2_000_000,), (1024, 28), (28,), (3, 5), (1,)):
            a = jr.uniform(key, shape, dev).cpu()
            b = jr.uniform(key, shape, "cpu")
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"jrandom: uniform{shape} seed {seed} differs on the card")
            n_checked += 1
        counter = torch.arange(64, dtype=torch.int64, device=dev)
        k0, k1 = jr.threefry2x32(key[0], key[1], torch.zeros_like(counter), counter)
        if list(zip(k0.tolist(), k1.tolist())) != jr.split(key, 64):
            raise AssertionError(f"jrandom: split keys of seed {seed} differ on the card")
        if (k0[9].item(), k1[9].item()) != jr.fold_in(key, 9):
            raise AssertionError(f"jrandom: fold_in of seed {seed} differs on the card")
        n_checked += 2
    rec = {"jrandom_checks": n_checked}
    print(f"jrandom ok: {json.dumps(rec)}", flush=True)
    return rec


def trees_equal(ma, mb) -> bool:
    for ta, tb in zip(ma.booster.trees_per_class, mb.booster.trees_per_class):
        for f in ("feat", "split_bin", "default_left", "is_split"):
            if not np.array_equal(np.stack(getattr(ta, f)), np.stack(getattr(tb, f))):
                return False
    return True


def split_trees_equal(ma, mb) -> bool:
    """The same nodes split, each on the same feature, bin and NA direction.
    A node left unsplit keeps a candidate that no row reads, so candidates
    are compared where a node splits."""
    for ta, tb in zip(ma.booster.trees_per_class, mb.booster.trees_per_class):
        split = np.stack(ta.is_split)
        if not np.array_equal(split, np.stack(tb.is_split)):
            return False
        for f in ("feat", "split_bin", "default_left"):
            if not np.array_equal(np.stack(getattr(ta, f))[split],
                                  np.stack(getattr(tb, f))[split]):
                return False
    return True


class CacheKeys:
    """The ``tree_bins`` entries the device frame cache should hold, as the
    booster keys them: (frame, nbins, seed, device) stands for (the frame's
    column stamps, the edges' digest and nbins, the device), since a frame,
    a bin count and a seed give one set of edges. A fit's lookup hits iff
    its key was placed before: every entry of this run fits the budget,
    which ``check_no_evictions`` confirms at the end."""

    def __init__(self):
        self.placed = set()
        self.names = {}

    def name(self, frame, name):
        self.names[id(frame)] = name
        return frame

    def expect(self, frame, nbins, seed, device):
        import torch

        key = (self.names[id(frame)], nbins, seed, torch.device(device).type)
        hit = key in self.placed
        self.placed.add(key)
        return (1, 0) if hit else (0, 1)


def tree_bins_counts():
    """(hits, misses) of the device frame cache's ``tree_bins`` lookups so far."""
    from h2o3_tpu_torch.frame.devcache import DEVCACHE

    c = DEVCACHE.stats()["kinds"].get("tree_bins", {"hits": 0, "misses": 0})
    return c["hits"], c["misses"]


def counted_train(keys, label, builder_cls, frame, device="cuda", **kw):
    """Train one builder on ``device`` and check its device frame cache
    lookup against ``keys``: exactly the hits and misses the keys give, and
    the entry it used lies on its device (a card fit served codes kept on
    the CPU would fail here). Returns (model, {"hits", "misses"})."""
    import torch

    from h2o3_tpu_torch.frame.devcache import DEVCACHE

    builder = builder_cls(response_column="y", device=str(device), **kw)
    want = keys.expect(frame, builder.params.nbins, builder.params.actual_seed(), device)
    h0, m0 = tree_bins_counts()
    model = builder.train(frame)
    h1, m1 = tree_bins_counts()
    got = (h1 - h0, m1 - m0)
    if got != want:
        raise AssertionError(
            f"{label}: device frame cache (hits, misses) {got}, expected {want}")
    key, entry = next(reversed(DEVCACHE._entries.items()))
    dev = torch.device(device).type
    if key[3][0] != dev or entry.value.bins_fm.device.type != dev:
        raise AssertionError(
            f"{label}: the fit on {dev} used an entry on {entry.value.bins_fm.device}")
    return model, {"hits": got[0], "misses": got[1]}


def frame_entry(frame, nbins):
    """The device frame cache's card entry for ``frame``'s codes at ``nbins``."""
    from h2o3_tpu_torch.frame import devcache

    token = devcache.frame_token(frame)
    found = [e for k, e in devcache.DEVCACHE._entries.items()
             if k[0] == "tree_bins" and k[1][0] == token and k[2][1] == nbins
             and k[3][0] == "cuda"]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} card entries for the frame at {nbins} bins")
    return found[0]


def check_no_evictions():
    from h2o3_tpu_torch.frame.devcache import DEVCACHE

    st = DEVCACHE.stats()
    if st["kinds"]["tree_bins"]["evictions"]:
        raise AssertionError(f"device frame cache evicted entries: {st}")
    return st


def adversarial_frame(n, n_feat, nbins, seed):
    """A float32 frame of the values binning can get wrong, with its edges
    (made from the float64 data, so most lie between two float32 values):
    5% NaN, +-inf, -0.0 beside 0.0, values set to an edge rounded to
    float32 and to its float32 neighbours, a 3-value column (edges padded
    with +inf) and an all-NaN column."""
    from h2o3_tpu_torch.ops.histogram import make_bins

    rng = np.random.default_rng(seed)
    f = n_feat - 3
    X = rng.normal(size=(n, n_feat))
    X[:, f] = rng.integers(0, 3, n)
    X[:, f + 1] = 0.0
    X[:, f + 2] = np.nan
    X[:, :f][rng.random((n, f)) < 0.05] = np.nan
    edges = make_bins(X, nbins, seed=seed)
    X = X.astype(np.float32)
    m = n // 8
    for j in range(f + 2):
        for v in (np.inf, -np.inf, -0.0):
            X[rng.integers(0, n, 100), j] = v
        finite = edges[j][np.isfinite(edges[j])]
        if finite.size:  # not the constant column
            e = rng.choice(finite, m).astype(np.float32)
            X[rng.integers(0, n, m), j] = e
            X[rng.integers(0, n, m), j] = np.nextafter(e, np.float32(np.inf))
            X[rng.integers(0, n, m), j] = np.nextafter(e, np.float32(-np.inf))
    return X, edges


def binning_phase(X, seed, dev, reps=3):
    """The fit's device binning (``apply_bins_device``) against the host
    ``apply_bins`` it replaces: ``torch.equal`` to its codes, transposed,
    at N x 28 for 256, 20 and 512 bins and on a 100,000-row adversarial
    frame; the host's seconds and the device's milliseconds, the upload of
    X included (the first call, then the mean of ``reps``)."""
    import torch

    from h2o3_tpu_torch.ops.histogram import apply_bins, apply_bins_device, make_bins

    cases = [(f"N={X.shape[0]} F={X.shape[1]} nbins={b}", X,
              make_bins(X, b, seed=seed)) for b in (256, 20, 512)]
    Xa, ea = adversarial_frame(100_000, 28, 256, seed)
    cases.append(("adversarial N=100000 F=28 nbins=256", Xa, ea))
    recs = []
    for name, x, edges in cases:
        t0 = time.time()
        host = apply_bins(x, edges)
        host_s = time.time() - t0
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.time()
            got = apply_bins_device(x, edges, dev)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        if not torch.equal(got.cpu(), torch.from_numpy(np.ascontiguousarray(host.T))):
            raise AssertionError(f"binning {name}: device codes differ from apply_bins")
        rec = {"case": name, "torch_equal": True, "host_s": host_s,
               "device_first_ms": times[0], "device_ms": sum(times[1:]) / reps,
               "na_codes": int((host == edges.shape[1] + 1).sum())}
        print(f"binning ok: {json.dumps(rec)}", flush=True)
        recs.append(rec)
    return recs


def cv_phase(keys, builder_cls, frame, n_rows, seed, trees, dev="cuda"):
    """Cross-validation through the kernels: ``nfolds=3`` (random) with
    ``trees`` trees; the CV AUC finite and above 0.5; each fit's 6 node-matmul
    launches per tree (the main fit and the 3 fold fits); each fold frame a
    cache miss (its rows are new columns); the same run with the plain
    histogram on the card gives equal trees in every fold (or a CV AUC
    within 1e-4)."""
    from h2o3_tpu_torch.ops import cuda_build

    kw = dict(ntrees=trees, seed=seed, nfolds=3, fold_assignment="random",
              keep_cross_validation_predictions=True)
    runs = {}
    for impl in ("kernel", "plain"):
        cuda_build.reset_launch_counts()
        h0, m0 = tree_bins_counts()
        want = keys.expect(frame, 256, seed, dev)
        t0 = time.time()
        model = builder_cls(response_column="y", hist_impl=impl, device=str(dev),
                            **kw).train(frame)
        train_s = time.time() - t0
        h1, m1 = tree_bins_counts()
        launches = dict(cuda_build.LAUNCHES)
        got = (h1 - h0, m1 - m0)
        if got != (want[0], want[1] + 3):
            raise AssertionError(f"cv {impl}: device frame cache (hits, misses) {got}, "
                                 f"expected {(want[0], want[1] + 3)}")
        runs[impl] = (model, launches, train_s, got)
    model, launches, train_s, got = runs["kernel"]
    expect = {"hist_nodematmul": 4 * trees * 6, "hist_sorted": 0, "hist_factorized": 0}
    if launches != expect:
        raise AssertionError(f"cv: kernel launches {launches}, expected {expect}")
    auc = model.cross_validation_metrics.auc
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"cv: AUC {auc} is not finite and above 0.5")
    hold = model.cv_holdout_predictions
    if hold.shape != (n_rows, 2) or not np.all(np.isfinite(hold)):
        raise AssertionError(f"cv: holdout predictions are not {n_rows} x 2 finite values")
    plain = runs["plain"][0]
    folds_equal = [trees_equal(a, b) for a, b in zip(model.cv_models, plain.cv_models)]
    plain_auc = plain.cross_validation_metrics.auc
    if not all(folds_equal) and abs(plain_auc - auc) > 1e-4:
        raise AssertionError(f"cv: the plain-histogram CV differs (AUC {plain_auc} vs {auc})")
    rec = {"fit": "xgboost_cv3", "rows": n_rows, "train_s": train_s, "cv_auc": auc,
           "launches": launches, "cache": {"hits": got[0], "misses": got[1]},
           "plain_cache": dict(zip(("hits", "misses"), runs["plain"][3])),
           "plain_train_s": runs["plain"][2], "plain_cv_auc": plain_auc,
           "plain_folds_trees_equal": folds_equal,
           "fold_timings": [timing_split(m) for m in model.cv_models]}
    print(f"cv ok: {json.dumps(rec)}", flush=True)
    return rec


def timing_split(model):
    """A fit's ``train_s`` in parts (``model.timings``), seconds:
    ``tree_fit_setup``, the booster's prep (``make_bins``, the bin codes
    made and placed, the rest), the boosting loop, the training metrics."""
    t = model.timings
    return {"setup_s": t["setup_s"], "prep_s": t["prep_s"], "bins_s": t["bins_s"],
            "place_s": t["place_s"],
            "prep_rest_s": t["prep_s"] - t["bins_s"] - t["place_s"],
            "boost_s": t["train_s"], "metrics_s": t["metrics_s"]}


def run_fit(builder_cls, frame, n_rows, expect_launches, label, small_frame, keys,
            **kw):
    """Train + predict + score one builder on the card through the kernels,
    then check it against the plain histogram and, on ``small_frame`` (None:
    not), against the CPU. expect_launches: {kernel: launches} the fit must
    make, exactly; every train's device frame cache hits and misses are
    the ones ``keys`` gives."""
    import torch

    from h2o3_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    t0 = time.time()
    model, cache = counted_train(keys, label, builder_cls, frame, **kw)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    t0 = time.time()
    pred = model.predict(frame)
    predict_s = time.time() - t0
    t0 = time.time()
    perf = model.model_performance(frame)
    perf_s = time.time() - t0
    launches = dict(cuda_build.LAUNCHES)
    if launches != expect_launches:
        raise AssertionError(
            f"{label}: kernel launches on the main path {launches}, expected "
            f"{expect_launches} (one per level each kernel serves)")
    p1 = pred.col("p1").data
    if p1.shape != (n_rows,) or not np.all(np.isfinite(p1)):
        raise AssertionError(f"{label}: predictions are not {n_rows} finite values")
    auc = perf.auc
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"{label}: AUC {auc} is not finite and above 0.5")

    plain, plain_cache = counted_train(keys, f"{label} plain", builder_cls, frame,
                                       hist_impl="plain", **kw)
    same_plain = trees_equal(model, plain)
    plain_auc = plain.training_metrics.auc
    if not same_plain and abs(plain_auc - auc) > 1e-4:
        raise AssertionError(
            f"{label}: plain-histogram fit differs (AUC {plain_auc} vs {auc})")

    rec = {
        "fit": label, "rows": n_rows, "train_s": train_s,
        "train_rows_per_s": n_rows / train_s, "predict_s": predict_s,
        "predict_rows_per_s": n_rows / predict_s, "model_performance_s": perf_s,
        "auc": auc, "logloss": perf.logloss, "launches": launches,
        **timing_split(model), "cache": cache, "plain_cache": plain_cache,
        "plain_trees_equal": same_plain, "plain_auc": plain_auc,
    }
    if small_frame is not None:
        card, c1 = counted_train(keys, f"{label} small", builder_cls, small_frame, **kw)
        card_plain, c2 = counted_train(keys, f"{label} small plain", builder_cls,
                                       small_frame, hist_impl="plain", **kw)
        cpu, c3 = counted_train(keys, f"{label} small cpu", builder_cls, small_frame,
                                device="cpu", tree_subtract=True, **kw)
        rec["small_cache"] = {"card": c1, "card_plain": c2, "cpu": c3}
        same_cpu = trees_equal(card, cpu)
        if not same_cpu and abs(card.training_metrics.auc - cpu.training_metrics.auc) > 1e-4:
            raise AssertionError(f"{label}: small fit on the card differs from the CPU")
        rec.update({
            "small_card_vs_cpu_trees_equal": same_cpu,
            "small_card_vs_card_plain_trees_equal": trees_equal(card, card_plain),
            "small_auc_card_cpu": [card.training_metrics.auc, cpu.training_metrics.auc],
        })
    print(f"fit ok: {json.dumps(rec)}", flush=True)
    return rec, model


def continue_fit(builder_cls, frame, X, prior, n_trees, expect_launches, label,
                 monotone, keys, **kw):
    """Continue ``prior`` from its checkpoint to ``n_trees`` trees on the
    card, predict and score; check the launches of the new trees, the
    device frame cache lookups, the trees against one fit of ``n_trees``,
    and, for each constrained column, that 1,000 rows' margins move exactly
    in its direction as the column is swept over 20 values."""
    import torch

    from h2o3_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    t0 = time.time()
    model, cache = counted_train(keys, label, builder_cls, frame, ntrees=n_trees,
                                 checkpoint=prior.key, monotone_constraints=monotone,
                                 **kw)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = dict(cuda_build.LAUNCHES)
    t0 = time.time()
    model.predict(frame)
    predict_s = time.time() - t0
    t0 = time.time()
    model.model_performance(frame)
    perf_s = time.time() - t0
    if launches != expect_launches:
        raise AssertionError(
            f"{label}: kernel launches of the continued trees {launches}, "
            f"expected {expect_launches}")
    if model.ntrees_built != n_trees:
        raise AssertionError(f"{label}: {model.ntrees_built} trees, expected {n_trees}")
    auc = model.training_metrics.auc
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"{label}: AUC {auc} is not finite and above 0.5")

    single, single_cache = counted_train(keys, f"{label} single", builder_cls, frame,
                                         ntrees=n_trees, monotone_constraints=monotone,
                                         **kw)
    same_single = trees_equal(model, single)
    single_auc = single.training_metrics.auc
    if not same_single and abs(single_auc - auc) > 1e-4:
        raise AssertionError(
            f"{label}: one {n_trees}-tree fit differs (AUC {single_auc} vs {auc})")

    rec = {
        "fit": label, "trees": n_trees, "train_s": train_s, "predict_s": predict_s,
        "model_performance_s": perf_s, "auc": auc,
        "launches": launches, **timing_split(model), "cache": cache,
        "single_cache": single_cache,
        "single_fit_trees_equal": same_single,
        "single_fit_auc": single_auc,
        "monotone_sweeps": monotone_sweeps(label, model, X, monotone),
    }
    print(f"continued fit ok: {json.dumps(rec)}", flush=True)
    return rec


def monotone_sweeps(label, model, X, monotone):
    """For each constrained column, 1,000 rows' margins move exactly in its
    direction as the column is swept over 20 values, and some rows move."""
    rows = X[:1000]
    sweeps = {}
    for col, direction in monotone.items():
        j = int(col[1:])
        margins = []
        for v in np.linspace(-3.0, 3.0, 20, dtype=np.float32):
            Xs = rows.copy()
            Xs[:, j] = v
            margins.append(model.booster.predict_margin(Xs)[:, 0])
        steps = direction * np.diff(np.stack(margins), axis=0)
        if not np.all(steps >= 0):
            raise AssertionError(
                f"{label}: margins move against {col}'s constraint {direction} "
                f"(worst step {steps.min()})")
        moving = int(np.sum(np.any(steps > 0, axis=0)))
        if moving == 0:
            raise AssertionError(
                f"{label}: no row's margin moves with {col}: the sweep checks nothing")
        sweeps[col] = {"direction": direction, "rows_that_move": moving}
    return sweeps


def f32_auc(keys, label, builder_cls, frame, **kw):
    """Training AUC of the f32 twin of a bf16 fit (its launches uncounted;
    its cache lookup checked: the codes do not depend on the operand mode)."""
    return counted_train(keys, label, builder_cls, frame, **kw)[0].training_metrics.auc


def profile_fit(builder_cls, frame, label, **kw):
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
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    rec = {
        "fit": label, "fit_wall_s": wall_s, "prep_s": model.timings["prep_s"],
        "boost_s": model.timings["train_s"], "device_busy_ms": busy_ms,
        "device_idle_share_of_fit": 1 - busy_ms / 1e3 / wall_s,
        "top_device_ms": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                          for e in top],
    }
    print(f"profile: {json.dumps(rec)}", flush=True)
    return rec


def compile_pojo(src, workdir, row_type=None):
    """The C POJO as a shared library, built with the host's C compiler
    (the one nvcc itself needs); a tree POJO reads float rows, a GLM's
    double rows (``row_type``)."""
    import ctypes
    import os
    import shutil

    row_type = row_type or ctypes.c_float

    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise AssertionError("surface: no host C compiler for the POJO")
    c_path, so_path = os.path.join(workdir, "pojo.c"), os.path.join(workdir, "pojo.so")
    with open(c_path, "w") as fh:
        fh.write(src)
    subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", so_path, c_path, "-lm"],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so_path)
    lib.score.argtypes = [ctypes.POINTER(row_type), ctypes.POINTER(ctypes.c_double)]
    return lib


def pojo_scores(lib, X, n_out, dtype=np.float32):
    import ctypes

    row_type = ctypes.c_float if dtype == np.float32 else ctypes.c_double
    out = np.zeros((X.shape[0], n_out))
    buf = np.zeros(n_out, dtype=np.float64)
    for i in range(X.shape[0]):
        row = np.ascontiguousarray(X[i], dtype=dtype)
        lib.score(row.ctypes.data_as(ctypes.POINTER(row_type)),
                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        out[i] = buf
    return out


def surface_phase(model, drf_model, frame, n_rows, dev="cuda", sub_rows=300_000,
                  shap_rows=2_000, export_rows=10_000):
    """The scoring surface on ``dev``, on the f32 XGBoost fit (and the f32
    DRF fit for the MOJO): batched scoring, thresholds, make_metrics,
    TreeSHAP, variable importances, save/load, MOJO, C POJO, and the entry
    step against the CPU's. Every check raises; returns the record with
    each time."""
    import tempfile

    import torch

    from h2o3_tpu_torch.entry import entry
    from h2o3_tpu_torch.genmodel import load_mojo
    from h2o3_tpu_torch.models import metrics as M
    from h2o3_tpu_torch.models import persist
    from h2o3_tpu_torch.models.tree.common import tree_matrix

    rec = {"rows": n_rows, "sub_rows": sub_rows}
    sub = frame.rows(slice(0, sub_rows))

    # one scoring pass for [frame, frame, sub]: each caller gets the bits of
    # a pass over its frame alone
    t0 = time.time()
    batched = model.predict_raw_batched([frame, frame, sub])
    rec["batched_s"] = time.time() - t0
    t0 = time.time()
    alone = [model._predict_raw(f) for f in (frame, frame, sub)]
    rec["three_passes_s"] = time.time() - t0
    for i, ((raw, _), want) in enumerate(zip(batched, alone)):
        if not np.array_equal(raw, want):
            raise AssertionError(f"surface: batched caller {i} is not its own pass's bits")
    raw = batched[0][0]

    # thresholds move the labels; make_metrics on the raw scores is
    # model_performance
    thr = model.default_threshold()
    labels = model.prediction_from_raw(raw).col("predict").data
    new_thr = 0.5 if abs(thr - 0.5) > 0.05 else 0.3
    if model.reset_threshold(new_thr) != thr:
        raise AssertionError("surface: reset_threshold did not return the old threshold")
    moved = model.prediction_from_raw(raw).col("predict").data
    if not np.array_equal(moved, (raw[:, 1] >= new_thr).astype(np.int32)):
        raise AssertionError("surface: labels do not follow the reset threshold")
    n_moved = int(np.sum(moved != labels))
    if n_moved == 0:
        raise AssertionError("surface: reset_threshold moved no label")
    model.reset_threshold(thr)
    rec.update(threshold=thr, reset_threshold=new_thr, labels_moved=n_moved)
    y = frame.col("y").data.astype(np.float64)
    t0 = time.time()
    made = M.make_metrics(raw, y, domain=["0", "1"])
    rec["make_metrics_s"] = time.time() - t0
    t0 = time.time()
    perf = model.model_performance(frame)
    rec["model_performance_s"] = time.time() - t0
    for key in ("auc", "pr_auc", "logloss", "mse", "max_f1_threshold", "nobs"):
        if getattr(made, key) != getattr(perf, key):
            raise AssertionError(f"surface: make_metrics {key} {getattr(made, key)} "
                                 f"!= model_performance {getattr(perf, key)}")

    # TreeSHAP on the first rows, over the training frame as background (its
    # rows reach every node, so no cover is zero): each row sums to its margin
    shap_frame = frame.rows(slice(0, shap_rows))
    t0 = time.time()
    contrib = model.predict_contributions(shap_frame, background_frame=frame)
    rec["contributions_s"] = time.time() - t0
    rec["contributions_rows_per_s"] = shap_rows / rec["contributions_s"]
    phi = np.stack([contrib.col(c).data for c in contrib.names], 1)
    margin = model.booster.predict_margin(
        tree_matrix(model.data_info, shap_frame, model.tree_encoding))[:, 0]
    if not np.all(np.isfinite(phi)) or not np.allclose(phi.sum(1), margin,
                                                       rtol=1e-5, atol=1e-5):
        raise AssertionError("surface: contributions do not sum to the margin "
                             f"(worst {np.max(np.abs(phi.sum(1) - margin))})")
    rec["contributions_max_abs_err"] = float(np.max(np.abs(phi.sum(1) - margin)))
    imp = model.variable_importances()
    if abs(sum(imp.values()) - 1.0) > 1e-9:
        raise AssertionError(f"surface: importances sum to {sum(imp.values())}")

    with tempfile.TemporaryDirectory() as tmp:
        # save and load on the card
        path = f"{tmp}/model.bin"
        t0 = time.time()
        persist.save_model(model, path)
        rec["save_s"] = time.time() - t0
        t0 = time.time()
        loaded = persist.load_model(path, key=f"{model.key}_loaded", device=dev)
        rec["load_s"] = time.time() - t0
        want_dev = torch.device(dev).type
        if loaded.device.type != want_dev or loaded.booster.device.type != want_dev:
            raise AssertionError(f"surface: the loaded model is not on {dev}")
        if not np.array_equal(loaded._predict_raw(sub), alone[2]):
            raise AssertionError("surface: the loaded model scores other bits")
        t0 = time.time()
        blob = persist.dumps_model(model)
        rec["dumps_s"] = time.time() - t0
        if persist.dumps_model(model) != blob:
            raise AssertionError("surface: dumps_model gave other bytes the second time")
        rec["archive_bytes"] = len(blob)

        # MOJO (XGBoost and DRF) through the numpy scorer
        export = frame.rows(slice(0, export_rows))
        cols = {name: export.col(name).data for name in export.names if name != "y"}
        rec["mojo"] = {}
        for label, m in (("xgboost", model), ("drf", drf_model)):
            want = m._predict_raw(export)
            t0 = time.time()
            m.download_mojo(f"{tmp}/{label}.zip")
            got = load_mojo(f"{tmp}/{label}.zip").score(cols)
            err = float(np.max(np.abs(got - want)))
            if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"surface: {label} MOJO scores differ ({err})")
            rec["mojo"][label] = {"s": time.time() - t0, "max_abs_err": err}

        # the C POJO, compiled and called through ctypes, against predict
        t0 = time.time()
        lib = compile_pojo(model.pojo("c"), tmp)
        rec["pojo_build_s"] = time.time() - t0
        X32 = tree_matrix(model.data_info, export, model.tree_encoding)
        out = pojo_scores(lib, X32, 3)
        pred = model.predict(export)
        want = np.stack([pred.col("p0").data, pred.col("p1").data], 1)
        if not np.allclose(out[:, 1:], want, rtol=1e-5, atol=1e-6):
            raise AssertionError("surface: the C POJO differs from predict")
        rec["pojo_max_abs_err"] = float(np.max(np.abs(out[:, 1:] - want)))

    # the entry step on the card against the same step on the CPU
    fn, args = entry(dev)
    on_card = fn(*args).cpu()
    fn_cpu, args_cpu = entry("cpu")
    on_cpu = fn_cpu(*args_cpu)
    if not torch.allclose(on_card, on_cpu, rtol=0, atol=1e-6):
        raise AssertionError("surface: the entry step on the card differs from the CPU")
    rec["entry_bit_identical"] = bool(torch.equal(on_card, on_cpu))
    return rec


def synth_mnist(n_rows: int, seed: int):
    """MNIST-shaped data: 784 pixel columns in [0, 1] from 10 class
    templates plus noise, a 10-class label, and 78 pixels (10%: the first
    39 and the last 39, MNIST's top and bottom border) zero in every row."""
    rng = np.random.default_rng(seed)
    common = rng.random(784).astype(np.float32)
    templates = np.float32(0.7) * common + np.float32(0.3) * rng.random((10, 784)).astype(
        np.float32)
    label = rng.integers(0, 10, n_rows)
    X = templates[label] + np.float32(0.5) * rng.standard_normal(
        (n_rows, 784), dtype=np.float32)
    np.clip(X, 0.0, 1.0, out=X)
    X[:, :39] = 0.0
    X[:, -39:] = 0.0
    return X, label.astype(np.int32)


def mnist_frame(X, label):
    from h2o3_tpu_torch import ColType, Column, Frame

    cols = [Column(f"p{j}", X[:, j], ColType.NUM) for j in range(X.shape[1])]
    cols.append(Column("label", label, ColType.CAT, [str(k) for k in range(10)]))
    return Frame(cols)


def synth_prostate(n_rows: int, seed: int):
    """prostate.csv-shaped data (hex.glm's binomial example): AGE, RACE (3
    levels), DPROS (4 levels), DCAPS, PSA, VOL, GLEASON and the CAPSULE
    response, with the real file's ranges."""
    from h2o3_tpu_torch import ColType, Column, Frame

    rng = np.random.default_rng(seed)
    age = np.clip(np.round(rng.normal(66, 6.5, n_rows)), 43, 79)
    race = rng.choice(3, n_rows, p=[0.01, 0.9, 0.09]).astype(np.int32)
    dpros = rng.choice(4, n_rows, p=[0.26, 0.36, 0.25, 0.13]).astype(np.int32)
    dcaps = np.where(rng.random(n_rows) < 0.1, 2.0, 1.0)
    psa = np.round(np.exp(rng.normal(2.2, 1.0, n_rows)), 1)
    vol = np.where(rng.random(n_rows) < 0.45, 0.0, np.round(rng.gamma(2.0, 12.0, n_rows), 1))
    gleason = np.clip(np.round(rng.normal(6.4, 1.0, n_rows)), 0, 9)
    eta = (-0.7 + 0.5 * dpros + 0.05 * psa + 0.9 * (gleason - 6) + 0.6 * (dcaps - 1)
           - 0.01 * vol + 0.02 * (age - 66))
    capsule = (rng.random(n_rows) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    num = lambda name, v: Column(name, v, ColType.NUM)  # noqa: E731
    return Frame([num("AGE", age), Column("RACE", race, ColType.CAT, ["0", "1", "2"]),
                  Column("DPROS", dpros, ColType.CAT, ["1", "2", "3", "4"]),
                  num("DCAPS", dcaps), num("PSA", psa), num("VOL", vol),
                  num("GLEASON", gleason), num("CAPSULE", capsule)])


class GramTimer:
    """Counts the GLM's Gram passes (``glm._gram``) and times each on the
    card with CUDA events, uploads and downloads included."""

    def __init__(self, dev):
        from h2o3_tpu_torch.models import glm

        self.glm, self.orig, self.dev = glm, glm._gram, dev
        self.ms = []

    def __enter__(self):
        import torch

        def timed(Xd, wz, w, mesh=None):
            if Xd.device.type != "cuda":
                t0 = time.perf_counter()
                out = self.orig(Xd, wz, w, mesh)
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(Xd, wz, w, mesh)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            return out

        self.glm._gram = timed
        return self

    def __exit__(self, *exc):
        self.glm._gram = self.orig

    def take(self):
        ms, self.ms = self.ms, []
        return {"gram_calls": len(ms), "gram_ms": float(np.mean(ms)) if ms else None}


def devcache_counts(prefix):
    from h2o3_tpu_torch.frame.devcache import DEVCACHE

    kinds = DEVCACHE.stats()["kinds"]
    return {k: (v["hits"], v["misses"]) for k, v in kinds.items() if k.startswith(prefix)}


def glm_fit(label, frame, dev, timer, valid=None, **kw):
    """One GLM fit on ``dev``, with its record: train_s, the Gram passes
    and their mean ms, the iterations, and the device frame cache's hits
    and misses by GLM placement kind."""
    from h2o3_tpu_torch import GLM

    before = devcache_counts("glm_")
    timer.take()
    t0 = time.time()
    model = GLM(device=str(dev), **kw).train(frame, valid)
    rec = {"fit": label, "device": str(dev), "train_s": time.time() - t0,
           "iterations": model.iterations, **timer.take()}
    after = devcache_counts("glm_")
    rec["devcache"] = {k: [after[k][0] - before.get(k, (0, 0))[0],
                           after[k][1] - before.get(k, (0, 0))[1]]
                       for k in after if after[k] != before.get(k)}
    coefs = np.array(list(model.coefficients.values()))
    if not np.all(np.isfinite(coefs)):
        raise AssertionError(f"glm {label}: coefficients not finite")
    m = model.training_metrics
    for key in ("auc", "logloss", "mse", "mean_residual_deviance"):
        if hasattr(m, key):
            rec[key] = float(getattr(m, key))
    print(f"glm fit: {json.dumps(rec)}", flush=True)
    return model, rec


def _close(a, b, rtol, atol=0.0):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return bool(np.allclose(a, b, rtol=rtol, atol=atol)), float(np.max(np.abs(a - b)))


def glm_phase(frame, X, y, logit, mnist, prostate, dev, seed, sub_rows=200_000,
              export_rows=10_000, mnist_rows=60_000):
    """The GLM on ``dev``: binomial IRLSM on the HIGGS-shaped frame (and on
    its first ``sub_rows`` rows on the card and on the CPU: coefficients
    rtol 1e-4, AUC 1e-4, equal iterations), binomial L-BFGS against IRLSM
    at lambda 1e-4 (1e-3), a gaussian lambda search with ADMM (10 entries,
    training deviance never rising), multinomial IRLSM and L-BFGS fits on
    the MNIST-shaped frame, a prostate-shaped fit with p-values and 3-fold
    CV on the card and the CPU (coefficients rtol 1e-3, p-values 1e-2),
    and the binomial model's MOJO (numpy ``genmodel``) and C POJO against
    predict (1e-6). Every check raises."""
    import ctypes
    import tempfile

    import torch

    from h2o3_tpu_torch.genmodel import load_mojo
    from h2o3_tpu_torch.models.data_info import expand_matrix

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("glm: float32 matmuls must not run in TF32")
    n = len(y)
    rec = {"rows": n, "fits": []}
    with GramTimer(dev) as timer:
        # binomial IRLSM, lambda 0, on every row
        irlsm, r = glm_fit("binomial_irlsm", frame, dev, timer, family="binomial",
                           lambda_=0.0, response_column="y")
        rec["fits"].append(r)
        # the same design again at lambda 1e-4: the device design is a hit
        irlsm_l2, r = glm_fit("binomial_irlsm_l2", frame, dev, timer, family="binomial",
                              lambda_=1e-4, alpha=0.0, response_column="y")
        if r["devcache"].get("glm_design") != [1, 0]:
            raise AssertionError(f"glm: the second fit's design was not a cache hit: {r}")
        rec["fits"].append(r)
        lbfgs, r = glm_fit("binomial_lbfgs", frame, dev, timer, family="binomial",
                           solver="lbfgs", lambda_=1e-4, alpha=0.0, response_column="y")
        ok, err = _close(list(lbfgs.coefficients.values()),
                         list(irlsm_l2.coefficients.values()), 0.0, 1e-3)
        r["vs_irlsm_max_abs_err"] = err
        if not ok:
            raise AssertionError(f"glm: L-BFGS is {err} from IRLSM at lambda 1e-4")
        rec["fits"].append(r)

        # the card against the CPU on the first rows
        sub = make_frame(X[:sub_rows], y[:sub_rows])
        pair = []
        for d in (dev, "cpu"):
            m, r = glm_fit(f"binomial_irlsm_{sub_rows}_rows", sub, d, timer,
                           family="binomial", lambda_=0.0, response_column="y")
            pair.append(m)
            rec["fits"].append(r)
        a, b = pair
        ok, err = _close(list(a.coefficients.values()), list(b.coefficients.values()), 1e-4)
        auc_err = abs(a.training_metrics.auc - b.training_metrics.auc)
        rec["card_vs_cpu"] = {"coef_max_abs_err": err, "auc_err": auc_err,
                              "iterations": [a.iterations, b.iterations]}
        if not ok or auc_err > 1e-4 or a.iterations != b.iterations:
            raise AssertionError(f"glm: card and CPU fits differ: {rec['card_vs_cpu']}")

        # gaussian lambda search with ADMM on the HIGGS logit plus noise
        noise = np.random.default_rng(seed + 7).normal(size=n).astype(np.float32)
        from h2o3_tpu_torch import ColType, Column

        gframe = frame.add_column(Column("yg", logit + noise, ColType.NUM))
        search, r = glm_fit("gaussian_lambda_search", gframe, dev, timer,
                            family="gaussian", lambda_search=True, nlambdas=10,
                            alpha=0.5, response_column="yg", ignored_columns=["y"])
        dev_path = [e["deviance_train"] for e in search.lambda_path]
        r["lambda_path_deviance"] = dev_path
        if len(dev_path) != 10 or any(b > a * (1 + 1e-9) for a, b in zip(dev_path, dev_path[1:])):
            raise AssertionError(f"glm: lambda path {dev_path}")
        rec["fits"].append(r)

        # multinomial on the MNIST-shaped frame, by IRLSM and by L-BFGS. The
        # reference's cyclic per-class IRLSM, which the port follows, has
        # no step control and diverges on this frame (its probabilities
        # clipped at 1e-15; ROADMAP C6), so only the L-BFGS fit is held to
        # have learned
        mX, mlabel = mnist
        mframe = mnist_frame(mX[:mnist_rows], mlabel[:mnist_rows])
        priors = np.bincount(mlabel[:mnist_rows], minlength=10) / mnist_rows
        constant_logloss = float(-(priors * np.log(priors)).sum())
        for solver in ("irlsm", "lbfgs"):
            multi, r = glm_fit(f"multinomial_mnist_{solver}", mframe, dev, timer,
                               family="multinomial", solver=solver, lambda_=1e-3,
                               alpha=0.0, response_column="label")
            r.update(rows=mnist_rows, constant_logloss=constant_logloss)
            rec["fits"].append(r)
            if not np.isfinite(multi.training_metrics.logloss):
                raise AssertionError(f"glm: multinomial {solver} logloss not finite")
        if not multi.training_metrics.logloss < constant_logloss:
            raise AssertionError(f"glm: the multinomial L-BFGS fit did not learn: {r}")

        # prostate-shaped: p-values and 3-fold CV, the card against the CPU,
        # and the CPU against itself on the rows permuted: unstandardized,
        # AGE (mean 66) and the rare RACE level lie near the intercept, so
        # the float32 Gram's summation order moves coefficients by 1e-4 of
        # themselves (2.4e-4 at seed 0), and the normal tail multiplies a
        # z-value's relative error by z * phi(z) / sf(z) in its p-value
        # (about 5 at z = 2.2; 1.5e-3 at seed 0): card and CPU are held at
        # rtol 1e-3 on coefficients and 1e-2 on p-values, the permuted CPU
        # fit's spread printed beside them
        pair = []
        kw = dict(family="binomial", standardize=False, compute_p_values=True,
                  response_column="CAPSULE")
        for d in (dev, "cpu"):
            m, r = glm_fit("prostate_binomial", prostate, d, timer, nfolds=3, seed=seed, **kw)
            r["cv_auc"] = float(m.cross_validation_metrics.auc)
            pair.append(m)
            rec["fits"].append(r)
        perm = np.random.default_rng(seed).permutation(prostate.nrows)
        pair.append(glm_fit("prostate_binomial_permuted", prostate.rows(perm), "cpu",
                            timer, **kw)[0])

        def rel(m1, m2, what):
            x1, x2 = getattr(m1, what), getattr(m2, what)
            return max(abs(x1[k] - x2[k]) / abs(x2[k]) for k in x2)

        a, b, c = pair
        rec["prostate_card_vs_cpu"] = {
            "coef_max_rel_err": rel(a, b, "coefficients"),
            "p_value_max_rel_err": rel(a, b, "p_values"),
            "cpu_permuted_coef_max_rel_err": rel(c, b, "coefficients"),
            "cpu_permuted_p_value_max_rel_err": rel(c, b, "p_values")}
        names = sorted(b.coefficients)
        ok1, _ = _close([a.coefficients[k] for k in names], [b.coefficients[k] for k in names],
                        1e-3)
        ok2, _ = _close([a.p_values[k] for k in names], [b.p_values[k] for k in names],
                        1e-2)
        if not (ok1 and ok2):
            raise AssertionError(f"glm: prostate card and CPU differ: {rec['prostate_card_vs_cpu']}")

    # the binomial model's MOJO and C POJO against predict
    export = frame.rows(slice(0, export_rows))
    pred = irlsm.predict(export)
    want = np.stack([pred.col("p0").data, pred.col("p1").data], 1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        irlsm.download_mojo(f"{tmp}/glm.zip")
        got = load_mojo(f"{tmp}/glm.zip").score(
            {name: export.col(name).data for name in export.names if name != "y"})
        ok, err = _close(got, want, 0.0, 1e-6)
        rec["mojo"] = {"s": time.time() - t0, "max_abs_err": err}
        if not ok:
            raise AssertionError(f"glm: MOJO scores differ ({err})")
        lib = compile_pojo(irlsm.pojo("c"), tmp, ctypes.c_double)
        Xd, _ = expand_matrix(irlsm.data_info, export, dtype=np.float64)
        out = pojo_scores(lib, Xd, 3, np.float64)
        ok, err = _close(out[:, 1:], want, 0.0, 1e-6)
        rec["pojo_max_abs_err"] = err
        if not ok:
            raise AssertionError(f"glm: the C POJO differs from predict ({err})")
    return rec


def deeplearning_phase(mnist, higgs_frame, dev, seed, epochs=2, ae_rows=100_000,
                       export_rows=10_000):
    """DeepLearning on ``dev`` on the MNIST-shaped frame at the package's
    defaults (hidden [200, 200], rectifier, mini-batch 256): the init and a
    step's dropout masks bit-identical to the CPU's, one ADADELTA step
    within 1e-5 of the CPU's, an ``epochs``-epoch fit (logloss below the
    constant predictor's, misclassification below 0.5), continued to
    ``epochs + 1`` and equal to a straight fit, a dropout epoch, an SGD
    epoch with momentum, an autoencoder (hidden [14]) on ``ae_rows`` rows
    of the HIGGS-shaped frame, and the MOJO against predict (1e-5). Prints
    samples/s and ms per step of each epoch. Every check raises."""
    import tempfile

    import torch

    from h2o3_tpu_torch import DeepLearning
    from h2o3_tpu_torch.genmodel import load_mojo
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models import deeplearning as dl
    from h2o3_tpu_torch.util import jrandom as jr

    mX, mlabel = mnist
    frame = mnist_frame(mX, mlabel)
    n = len(mlabel)
    rec = {"rows": n, "fits": []}
    sizes = [784, 200, 200, 10]
    key = jr.split(jr.PRNGKey(seed))[1]
    on_dev = dl._init_params(key, sizes, dev)
    on_cpu = dl._init_params(key, sizes, "cpu")
    for (a, _), (b, _) in zip(on_dev, on_cpu):
        if not torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)):
            raise AssertionError("deeplearning: the init on the card is not the CPU's bits")
    # the first step's masks (epoch 0, step 0): input 0.2, hidden 0.5
    dk = jr.fold_in(jr.fold_in(jr.PRNGKey(seed), 1), 0)
    for shape, p in (((256, 784), 0.8), ((256, 200), 0.5), ((256, 200), 0.5)):
        dk, sub = jr.split(dk)
        if not torch.equal(jr.bernoulli(sub, p, shape, dev).cpu(),
                           jr.bernoulli(sub, p, shape, "cpu")):
            raise AssertionError("deeplearning: a dropout mask differs on the card")
    rec["init_and_masks_bit_identical"] = True

    base = dict(response_column="label", seed=seed, hidden=[200, 200], mini_batch_size=256)
    # one ADADELTA step of 256 rows on the card and on the CPU
    step_frame = frame.rows(slice(0, 256))
    one = [DeepLearning(device=str(d), epochs=1, **base).train(step_frame)
           for d in (dev, "cpu")]
    err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
              for (Wa, ba), (Wb, bb) in zip(one[0].net_params, one[1].net_params)
              for a, b in ((Wa, Wb), (ba, bb)))
    rec["one_step_max_abs_err"] = err
    if err > 1e-5:
        raise AssertionError(f"deeplearning: one step on the card is {err} from the CPU's")

    def fit(label, on=frame, **kw):
        t0 = time.time()
        model = DeepLearning(device=str(dev), **dict(base, **kw)).train(on)
        r = {"fit": label, "train_s": time.time() - t0,
             "epochs_trained": model.epochs_trained}
        t = model.timings
        rows = int(t["steps_per_epoch"]) * int(t["batch"])
        r["samples_per_s"] = [rows / s for s in t["epoch_s"]]
        r["ms_per_step"] = [1e3 * s / t["steps_per_epoch"] for s in t["epoch_s"]]
        leaves = [np.asarray(w) for layer in model.net_params for w in layer]
        if not all(np.all(np.isfinite(w)) for w in leaves):
            raise AssertionError(f"deeplearning {label}: weights not finite")
        print(f"deeplearning fit: {json.dumps(r)}", flush=True)
        rec["fits"].append(r)
        return model, r

    main, r = fit("adadelta", epochs=epochs)
    m = main.training_metrics
    priors = np.bincount(mlabel, minlength=10) / n
    constant_logloss = float(-(priors * np.log(priors)).sum())
    t0 = time.time()
    pred = main.predict(frame)
    r["predict_s"] = time.time() - t0
    miss = float(np.mean(pred.col("predict").data != mlabel))
    r.update(logloss=float(m.logloss), constant_logloss=constant_logloss,
             misclassification=miss)
    if not (np.isfinite(m.logloss) and m.logloss < constant_logloss and miss < 0.5):
        raise AssertionError(f"deeplearning: the fit did not learn: {r}")

    # checkpoint-continue to epochs + 1 against a straight fit
    cont, r = fit("adadelta_continued", epochs=epochs + 1, checkpoint=main.key)
    straight, r2 = fit("adadelta_straight", epochs=epochs + 1)
    diffs = [float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
             for (Wa, ba), (Wb, bb) in zip(cont.net_params, straight.net_params)
             for a, b in ((Wa, Wb), (ba, bb))]
    bits = all(d == 0.0 for d in diffs) and all(
        np.array_equal(a, b) for a, b in zip(cont.opt_leaves, straight.opt_leaves))
    rec["continue"] = {"bit_identical": bits, "max_abs_err": max(diffs)}
    if not bits and max(diffs) > 1e-6:
        raise AssertionError(f"deeplearning: the continued fit differs: {rec['continue']}")
    print(f"deeplearning continue: {json.dumps(rec['continue'])}", flush=True)

    drop, r = fit("dropout", epochs=1, input_dropout_ratio=0.2, hidden_dropout_ratios=[0.5, 0.5])
    r["logloss"] = float(drop.training_metrics.logloss)
    sgd, r = fit("sgd_momentum", epochs=1, adaptive_rate=False, momentum_start=0.5,
                 momentum_stable=0.99, rate_annealing=1e-6)
    r["logloss"] = float(sgd.training_metrics.logloss)
    if not (np.isfinite(r["logloss"]) and np.isfinite(rec["fits"][-2]["logloss"])):
        raise AssertionError("deeplearning: the dropout or SGD fit's logloss is not finite")

    # the autoencoder on the HIGGS-shaped frame
    ae_frame = higgs_frame.rows(slice(0, ae_rows))
    ae, r = fit("autoencoder", on=ae_frame, epochs=1, autoencoder=True, hidden=[14],
                response_column=None, ignored_columns=["y"])
    t0 = time.time()
    score = ae.anomaly(ae_frame)
    r["anomaly_s"] = time.time() - t0
    r["anomaly_mean"] = float(np.mean(score))
    if score.shape != (ae_rows,) or not np.all(np.isfinite(score)):
        raise AssertionError("deeplearning: anomaly is not finite")

    # the MOJO against predict
    export = frame.rows(slice(0, export_rows))
    want = main._predict_raw(export)
    with tempfile.TemporaryDirectory() as tmp:
        main.download_mojo(f"{tmp}/dl.zip")
        got = load_mojo(f"{tmp}/dl.zip").score(
            {name: export.col(name).data for name in export.names if name != "label"})
    ok, err = _close(got, want, 0.0, 1e-5)
    rec["mojo_max_abs_err"] = err
    if not ok:
        raise AssertionError(f"deeplearning: MOJO scores differ ({err})")
    for model in one + [main, cont, straight, drop, sgd, ae]:
        DKV.remove(model.key)
    return rec


def synth_airlines(n_rows: int, seed: int):
    """A frame with the columns of H2O-3's airlines demo frame
    (allyears2k_headers / airlines 1987-2008): numeric Year, Month,
    DayofMonth, DayOfWeek, CRSDepTime, CRSArrTime (hhmm), FlightNum and
    Distance; categorical UniqueCarrier (20 levels), Origin and Dest (300
    levels each, Zipf-skewed like airport traffic), with about 0.5% NAs in
    each categorical and in Distance; the response IsDepDelayed (NO/YES,
    about 45% YES) drawn from a logistic model with per-carrier and
    per-origin effects, the hour of departure, the month and the distance."""
    from h2o3_tpu_torch import ColType, Column, Frame

    rng = np.random.default_rng(seed)
    n = n_rows

    def zipf_codes(levels, power):
        p = 1.0 / np.arange(1, levels + 1) ** power
        codes = rng.choice(levels, n, p=p / p.sum()).astype(np.int32)
        codes[rng.random(n) < 0.005] = -1
        return codes

    def names(levels, width):
        out = []
        for i in range(levels):
            s = ""
            for _ in range(width):
                s = chr(65 + i % 26) + s
                i //= 26
            out.append(s)
        return out

    year = rng.integers(1987, 2009, n).astype(np.float64)
    month = rng.integers(1, 13, n).astype(np.float64)
    day = rng.integers(1, 32, n).astype(np.float64)
    dow = rng.integers(1, 8, n).astype(np.float64)
    hour_p = np.array([1, 1, 1, 1, 2, 8, 14, 14, 13, 12, 12, 12, 12, 12, 12, 12, 12,
                       12, 11, 10, 8, 6, 4, 2], dtype=np.float64)
    dep_h = rng.choice(24, n, p=hour_p / hour_p.sum())
    dep_min = dep_h * 60 + 5 * rng.integers(0, 12, n)
    distance = np.clip(np.round(np.exp(rng.normal(6.3, 0.7, n))), 30, 4983)
    arr_min = (dep_min + 30 + distance / 8 + rng.integers(-10, 30, n)).astype(np.int64) % 1440
    carrier = zipf_codes(20, 0.8)
    origin = zipf_codes(300, 0.9)
    dest = zipf_codes(300, 0.9)
    carrier_eff = rng.normal(0, 0.5, 20)
    origin_eff = rng.normal(0, 0.6, 300)
    eta = (np.where(carrier >= 0, carrier_eff[np.maximum(carrier, 0)], 0.0)
           + np.where(origin >= 0, origin_eff[np.maximum(origin, 0)], 0.0)
           + 0.09 * (dep_h - 12) + 0.3 * np.isin(month, (6, 7, 12))
           + 0.15 * (dow == 5) + 0.2 * (distance > 1500))
    lo, hi = -5.0, 5.0  # the intercept that makes 45% of flights late
    for _ in range(60):
        mid = (lo + hi) / 2
        if np.mean(1 / (1 + np.exp(-(eta + mid)))) < 0.45:
            lo = mid
        else:
            hi = mid
    late = (rng.random(n) < 1 / (1 + np.exp(-(eta + lo)))).astype(np.int32)
    distance[rng.random(n) < 0.005] = np.nan
    num = lambda name, v: Column(name, v.astype(np.float64), ColType.NUM)  # noqa: E731
    airports = names(300, 3)
    return Frame([
        num("Year", year), num("Month", month), num("DayofMonth", day),
        num("DayOfWeek", dow),
        num("CRSDepTime", (dep_min // 60) * 100 + dep_min % 60),
        num("CRSArrTime", (arr_min // 60) * 100 + arr_min % 60),
        Column("UniqueCarrier", carrier, ColType.CAT, names(20, 2)),
        num("FlightNum", rng.integers(1, 7500, n).astype(np.float64)),
        Column("Origin", origin, ColType.CAT, airports),
        Column("Dest", dest, ColType.CAT, list(airports)),
        num("Distance", distance),
        Column("IsDepDelayed", late, ColType.CAT, ["NO", "YES"]),
    ])


def automl_steps(aml):
    """The event log without keys, times and metric values: what happened
    to each step, in order."""
    out = []
    for e in aml.event_log.events:
        msg = e["message"]
        if " -> " in msg:
            msg = msg.split(" -> ")[0] + " -> model"
        elif msg.startswith(("AutoML build", "target encoding applied",
                             "exploitation: refining")):
            msg = msg.split(":")[0]
        out.append(msg)
    return out


def automl_models_by_step(aml):
    """{step id: [models]} from the event log (a grid step adds several)."""
    by_key = {m.key: m for m in aml.leaderboard.models}
    out = {}
    for e in aml.event_log.events:
        msg = e["message"]
        if " -> " in msg and " metric=" in msg:
            step, rest = msg.split(" -> ")
            out.setdefault(step, []).append(by_key[rest.split(" ")[0]])
    return out


def automl_step_seconds(aml):
    """Wall seconds of each step, from its "starting" event to the event of
    its last model."""
    start, out = {}, {}
    for e in aml.event_log.events:
        msg = e["message"]
        if msg.startswith("step ") and msg.endswith(" starting"):
            start[msg[5:-9]] = e["timestamp"]
        elif " -> " in msg and msg.split(" -> ")[0] in start:
            out[msg.split(" -> ")[0]] = e["timestamp"] - start[msg.split(" -> ")[0]]
    return out


def automl_failures(aml, grids):
    """Every failure the run swallowed by design: failed steps and target
    encoding in the event log, failed grid cells."""
    bad = [e["message"] for e in aml.event_log.events if "failed" in e["message"]]
    bad += [f"grid {g.grid_id}: {hp}: {err}" for g in grids for hp, err in g.failures]
    return bad


class tree_subtract_default:
    """Within the block, a GBM, XGBoost or DRF fit whose ``tree_subtract``
    is unset takes ``flow`` (None: the package's default, on for cuda and
    off for the CPU), as ``run_fit``'s small CPU fits take the card's flow
    with ``tree_subtract=True``; AutoML builds its models itself, so the
    default is set where the builders call the booster."""

    def __init__(self, flow):
        from h2o3_tpu_torch.models.tree import drf, gbm, xgboost

        self.flow, self.mods = flow, (drf, gbm, xgboost)
        self.orig = gbm.train_boosted

    def __enter__(self):
        if self.flow is not None:
            orig, flow = self.orig, self.flow

            def train_boosted(*a, subtract=None, **kw):
                return orig(*a, subtract=flow if subtract is None else subtract, **kw)

            for m in self.mods:
                m.train_boosted = train_boosted
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.train_boosted = self.orig


def automl_phase(frame, dev, seed, sub_rows=10_000, grid_trees=20):
    """AutoML on ``dev`` through the port's entry points: the default plan
    (``max_models=10``, ``nfolds=3``, ``seed=1``, target encoding) on the
    airlines-shaped frame, then the same run's card against the CPU on its
    first ``sub_rows`` rows, then a 4-cell GBM grid with two worker threads
    against one. Every check raises: a failed step, failed target encoding
    or a failed grid cell; a planned step that built no model; a model or
    encoder off ``dev``; the leader's metric not finite and above 0.5, or
    an ensemble missing; the leader scoring a raw frame other than the
    encoded one; save and load on ``dev`` changing a prediction bit; B1 or
    B2 not launched; the card's steps or their order against the CPU's,
    run once with the card's level flow (histogram subtraction) and once
    with the CPU's own (none); a card CV AUC further from the nearer CPU
    run's than 1e-4 or, where it is larger, than ten times the distance
    between the CPU's two runs (a depth-6 XGBoost with ``min_rows=1``
    meets near ties at every level and the order of its float sums
    decides them, ROADMAP C2 and C3, so its CV AUC moves by 4e-4 to 4e-3
    between the CPU's two runs; an ensemble over it inherits that; GLM and
    GBM stay within 1e-4), or leaderboard ranks
    apart where the gap exceeds that tolerance; the threaded grid's trees
    or leaves against the serial grid's. Returns the phase's record, with the main run's kernel
    launches under ``launches``."""
    import torch

    from h2o3_tpu_torch import GBM, AutoML, GridSearch
    from h2o3_tpu_torch.frame.devcache import DEVCACHE
    from h2o3_tpu_torch.models import grid as grid_mod
    from h2o3_tpu_torch.models import persist
    from h2o3_tpu_torch.ops import cuda_build

    y = "IsDepDelayed"
    grids = []
    orig_train = grid_mod.GridSearch.train

    def recording_train(self, *a, **kw):  # keeps every grid the runs build
        g = orig_train(self, *a, **kw)
        grids.append(g)
        return g

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    grid_mod.GridSearch.train = recording_train
    try:
        cache0 = DEVCACHE.stats()["kinds"]
        cuda_build.reset_launch_counts()
        t0 = time.time()
        aml = AutoML(max_models=10, nfolds=3, seed=1, preprocessing=["target_encoding"],
                     device=str(dev))
        leader = aml.train(y=y, training_frame=frame)
        sync()
        run_s = time.time() - t0
        launches = dict(cuda_build.LAUNCHES)
        cache1 = DEVCACHE.stats()["kinds"]
    finally:
        grid_mod.GridSearch.train = orig_train

    rec = {"rows": frame.nrows, "run_s": run_s, "launches": launches}
    bad = automl_failures(aml, grids)
    if bad:
        raise AssertionError(f"automl: failures in the run: {bad}")
    by_step = automl_models_by_step(aml)
    planned = [s.id for s in aml._default_plan()]
    missing = [s for s in planned if s not in by_step]
    if missing:
        raise AssertionError(f"automl: planned steps built no model: {missing}")
    models = aml.leaderboard.models
    nested = [aml._te_model] + [m.metalearner for m in models if m.algo_name ==
                                "stackedensemble"]
    off = [m.key for m in models + nested if m.device.type != dev.type]
    if off:
        raise AssertionError(f"automl: models off {dev}: {off}")
    metric = grid_mod.metric_value(leader)[0]
    algos = [m.algo_name for m in models]
    if not (np.isfinite(metric) and metric > 0.5) or algos.count("stackedensemble") != 2:
        raise AssertionError(f"automl: leader metric {metric}, leaderboard {algos}")
    if dev.type == "cuda" and not (launches["hist_nodematmul"] and launches["hist_sorted"]):
        raise AssertionError(f"automl: B1 and B2 must both launch, got {launches}")
    seconds = automl_step_seconds(aml)
    rec["steps"] = [
        {"step": step, "algo": m.algo_name, "model": m.key,
         "cv_auc": float(grid_mod.metric_value(m)[0]) if m.algo_name != "stackedensemble"
         else None,
         "training_auc": float(m.training_metrics.auc), "train_s": float(m.run_time),
         "step_s": float(seconds.get(step, float("nan")))}
        for step in planned for m in by_step[step]]
    rec["leaderboard"] = [{"algo": r["algo"], "metric": float(r["metric"]),
                           "model": r["model_id"]} for r in aml.leaderboard.as_table()]
    rec["events"] = automl_steps(aml)
    rec["devcache"] = {
        k: {c: v[c] - cache0.get(k, {}).get(c, 0) for c in ("hits", "misses", "evictions")}
        for k, v in cache1.items()}

    # the leader scores the raw frame through its target encoder, as the
    # encoded frame; predict rows/s of the raw frame
    encoded = aml._te_model.transform(frame)
    t0 = time.time()
    raw_pred = leader.predict(frame).col("pYES").data
    predict_s = time.time() - t0
    preds = {leader.key: raw_pred}
    if not np.array_equal(raw_pred, leader.predict(encoded).col("pYES").data):
        raise AssertionError("automl: the leader scores the raw frame differently")
    rec.update(leader=leader.key, leader_algo=leader.algo_name, leader_metric=metric,
               predict_s=predict_s, predict_rows_per_s=frame.nrows / predict_s)
    # the leader and the best-of-family ensemble survive save and load on dev
    best_of_family = by_step["stackedensemble_best_of_family"][0]
    rec["save_load"] = []
    for m in dict.fromkeys([leader, best_of_family]):
        t0 = time.time()
        blob = persist.dumps_model(m)
        back = persist.loads_model(blob, device=dev)
        want = preds[m.key] if m.key in preds else m.predict(frame).col("pYES").data
        if not np.array_equal(back.predict(frame).col("pYES").data, want):
            raise AssertionError(f"automl: {m.key} predicts differently after save/load")
        rec["save_load"].append({"model": m.key, "bytes": len(blob),
                                 "s": time.time() - t0})
    print(f"automl run ok: {json.dumps(rec)}", flush=True)

    # the card against the CPU on the first rows: the CPU once with the
    # card's level flow (histogram subtraction) and once with its own
    # default (none); the second tells how far this run's CV AUCs move
    # when only the order of the float sums changes
    sub = frame.rows(slice(0, sub_rows))
    kw = dict(max_models=3, nfolds=2, seed=1, preprocessing=["target_encoding"],
              include_algos=["xgboost", "gbm", "glm", "stackedensemble"])
    runs = {}
    for label, where, flow in (("card", dev, None), ("cpu", torch.device("cpu"), True),
                               ("cpu_no_subtraction", torch.device("cpu"), None)):
        grids.clear()
        grid_mod.GridSearch.train = recording_train
        try:
            with tree_subtract_default(flow):
                t0 = time.time()
                a = AutoML(device=str(where), **kw)
                a.train(y=y, training_frame=sub)
                sync()
                runs[label] = (a, time.time() - t0)
        finally:
            grid_mod.GridSearch.train = orig_train
        bad = automl_failures(a, grids)
        if bad:
            raise AssertionError(f"automl {label}: failures: {bad}")
        if automl_steps(a) != automl_steps(runs["card"][0]):
            raise AssertionError(f"automl: steps {label} {automl_steps(a)} against the "
                                 f"card's {automl_steps(runs['card'][0])}")
    by = {label: automl_models_by_step(a) for label, (a, _) in runs.items()}
    value = {label: {step: grid_mod.metric_value(ms[0])[0] for step, ms in b.items()}
             for label, b in by.items()}
    # the card's CV AUC lies within 1e-4 of the nearer CPU run's or, for a
    # step whose two CPU runs part by more, within ten times their distance
    diffs = {step: min(abs(value["card"][step] - value[cpu][step])
                       for cpu in ("cpu", "cpu_no_subtraction")) for step in value["card"]}
    spread = {step: abs(value["cpu"][step] - value["cpu_no_subtraction"][step])
              for step in value["card"]}
    tol = {step: max(1e-4, 10 * spread[step]) for step in value["card"]}
    step_of = {m.key: st for b in by.values() for st, ms in b.items() for m in ms}
    card_rank = [step_of[m.key] for m in runs["card"][0].leaderboard.models]
    cpu_rank = [step_of[m.key] for m in runs["cpu"][0].leaderboard.models]
    cpu_v = [value["cpu"][st] for st in cpu_rank]
    apart = [(cpu_rank[i], cpu_rank[k]) for i in range(len(cpu_rank))
             for k in range(i + 1, len(cpu_rank))
             if cpu_v[i] - cpu_v[k] > max(tol[cpu_rank[i]], tol[cpu_rank[k]])]
    swapped = [p for p in apart if card_rank.index(p[0]) > card_rank.index(p[1])]
    rec["card_vs_cpu"] = {"rows": sub.nrows,
                          **{f"{label}_s": s_ for label, (_, s_) in runs.items()},
                          "metric": value, "abs_diff": diffs, "cpu_spread": spread,
                          "card_rank": card_rank, "cpu_rank": cpu_rank, "swapped": swapped}
    over = {st: d for st, d in diffs.items() if d > tol[st]}
    if over or swapped:
        raise AssertionError(f"automl: card against CPU beyond max(1e-4, ten times the "
                             f"CPU's own spread) at {over}: {rec['card_vs_cpu']}")
    print(f"automl card vs cpu ok: {json.dumps(rec['card_vs_cpu'])}", flush=True)

    # a 4-cell Cartesian GBM grid with two worker threads, then one
    hyper = {"max_depth": [3, 5], "learn_rate": [0.1, 0.2]}
    built = {}
    for par in (2, 1):
        t0 = time.time()
        g = GridSearch(GBM, GBM(response_column=y, ntrees=grid_trees, seed=seed,
                                device=str(dev)).params, hyper, parallelism=par).train(frame)
        sync()
        if g.failures or len(g.models) != 4:
            raise AssertionError(f"automl: grid parallelism {par}: {g}, {g.failures}")
        built[par] = (g, time.time() - t0)
    (g2, s2), (g1, s1) = built[2], built[1]
    same = g2.hyper_params == g1.hyper_params and all(
        trees_equal(a, b) and all(np.array_equal(np.stack(ta.leaf), np.stack(tb.leaf))
                                  for ta, tb in zip(a.booster.trees_per_class,
                                                    b.booster.trees_per_class))
        for a, b in zip(g2.models, g1.models))
    rec["grid_threads"] = {"cells": len(g1.models), "trees": grid_trees,
                           "parallelism_2_s": s2, "parallelism_1_s": s1,
                           "equal": same}
    if not same:
        raise AssertionError("automl: the threaded grid's models differ from the serial grid's")
    print(f"automl grid ok: {json.dumps(rec['grid_threads'])}", flush=True)
    return rec


def breadth_fit(label, builder_cls, frame, dev, score=None, **kw):
    """One fit on ``dev`` and one scoring pass over ``frame`` (or ``score``),
    with its record: ``train_s``, predict rows/s and the device memory peak
    of the two (``torch.cuda.max_memory_allocated``, bytes)."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = builder_cls(device=str(dev), **kw).train(frame)
    if cuda:
        torch.cuda.synchronize()
    rec = {"fit": label, "device": str(dev), "rows": frame.nrows,
           "train_s": time.time() - t0}
    score = frame if score is None else score
    t0 = time.time()
    pred = model.predict(score)
    predict_s = time.time() - t0
    rec["predict_s"] = predict_s
    rec["predict_rows_per_s"] = score.nrows / predict_s
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    if hasattr(model, "iterations"):
        rec["iterations"] = int(model.iterations)
    if model.device != torch.device(dev):
        raise AssertionError(f"{label}: the model is on {model.device}, not {dev}")
    return model, rec, pred


def breadth_phase(higgs, blobs, mnist, airlines, dev, seed, sub_rows=200_000,
                  export_rows=10_000):
    """KMeans, PCA and SVD, GLRM, NaiveBayes and both isolation forests on
    ``dev``, each fitted on every row of its frame at the frame's full
    width and scored on its first ``sub_rows`` rows (the isolation forest
    on every row). On ``blobs``, the HIGGS-shaped features with cluster
    centres added (``clustered_frame``): KMeans k=10 by ``plus_plus`` (10
    iterations) and by ``estimate_k`` up to k=10. On the HIGGS-shaped
    frame (its 28 features): PCA k=10 standardized, SVD nv=10, the
    isolation forest at its defaults (50 trees, samples of 256, depth 8),
    the extended forest (100 trees, samples of 256) at extension levels 0
    and 27. On the MNIST-shaped frame (784 pixels): PCA k=50 demeaned; on
    it with 3% of its cells NA (``blank_cells``), GLRM k=10 with quadratic
    loss (exact ALS with the NA mask, 30 iterations at most) and with huber
    loss and l1 on X (the proximal line search, 10 iterations). On the
    airlines-shaped frame: NaiveBayes with ``laplace=1``.

    Then each family on the CPU against the card: on the first
    ``sub_rows`` rows of the clustered, HIGGS-shaped and airlines-shaped
    frames (fitted on both), and on the whole MNIST-shaped frames (the
    card's fits above): the forests' trees equal, the isolation forest's
    path lengths ``torch.equal``, the extended forest's ``mean_length``
    within rtol 1e-5 (the rows outside counted and printed: a projection
    within a float32 rounding of a threshold; at level 27 at most 20 rows,
    each off by no more than one tree's longest path over the tree count),
    KMeans ``tot_withinss`` rtol 1e-4 and ``estimate_k``'s k equal, PCA
    and SVD eigenvalues rtol 1e-4, GLRM objectives rtol 1e-3, NaiveBayes
    tables equal. The MOJOs of the KMeans, PCA, isolation-forest and NaiveBayes
    models scored by the port's ``genmodel`` on ``export_rows`` rows
    against ``Model.predict`` (rtol 1e-6; PCA's float32 scores against the
    scorer's float64 also atol 1e-5), and every model through
    ``dumps_model``/``loads_model`` on ``dev`` with the same prediction
    bits and the same bytes. Every check raises. Returns the phase's
    record."""
    import tempfile

    import torch

    from h2o3_tpu_torch import (
        GLRM, PCA, SVD, ExtendedIsolationForest, IsolationForest, KMeans, NaiveBayes)
    from h2o3_tpu_torch.genmodel import load_mojo
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models import persist
    from h2o3_tpu_torch.models.tree.common import tree_matrix

    dev = torch.device(dev)
    mnist_fr = mnist_frame(*mnist)
    glrm_fr = mnist_frame(blank_cells(mnist[0], seed + 16), mnist[1])
    rec = {"fits": []}
    models = {}
    cache0 = devcache_counts("kmeans_x") | devcache_counts("pca_x")

    def fit(label, builder_cls, frame, **kw):
        model, r, pred = breadth_fit(label, builder_cls, frame, dev, **kw)
        models[label] = (model, frame)
        rec["fits"].append(r)
        return model, r, pred

    # the clustered and the HIGGS-shaped frames: 28 features, the response
    # left out; the predict passes but the isolation forest's on their
    # first sub_rows rows
    blobs_sub = blobs.rows(slice(0, sub_rows))
    km, r, _ = fit("kmeans_plus_plus_k10", KMeans, blobs, k=10, init="plus_plus",
                   max_iterations=10, seed=seed, score=blobs_sub)
    r.update(tot_withinss=km.tot_withinss, betweenss=km.betweenss, totss=km.totss)
    kme, r, _ = fit("kmeans_estimate_k10", KMeans, blobs, k=10, estimate_k=True,
                    seed=seed, score=blobs_sub)
    r.update(k=int(kme.centers_std.shape[0]), tot_withinss=kme.tot_withinss,
             betweenss=kme.betweenss)
    if r["k"] < 2:
        raise AssertionError(f"kmeans estimate_k: k={r['k']} on the clustered frame")
    ig = ["y"]
    sub = higgs.rows(slice(0, sub_rows))
    pca, r, _ = fit("pca_k10_standardize", PCA, higgs, k=10, transform="standardize",
                    ignored_columns=ig, score=sub)
    r["pve"] = pca.pve.tolist()
    svd, r, _ = fit("svd_nv10", SVD, higgs, nv=10, ignored_columns=ig, score=sub)
    r.update(d=svd.d.tolist(), pve=svd.pve.tolist())
    iso, r, pred = fit("isolation_forest", IsolationForest, higgs, seed=seed,
                       ignored_columns=ig)
    s = pred.col("anomaly_score").data
    r.update(mean_score=float(s.mean()), max_score=float(s.max()),
             training_metrics=iso.training_metrics)
    for level in (0, 27):
        eif, r, pred = fit(f"ext_isolation_forest_level{level}", ExtendedIsolationForest,
                           higgs, ntrees=100, sample_size=256, extension_level=level,
                           seed=seed, ignored_columns=ig, score=sub)
        s = pred.col("anomaly_score").data
        r.update(mean_score=float(s.mean()), max_score=float(s.max()),
                 mean_length=float(pred.col("mean_length").data.mean()))
    # the MNIST-shaped frame: its 784 pixels, the label left out
    ig = ["label"]
    pm, r, _ = fit("pca_k50_demean_mnist", PCA, mnist_fr, k=50, transform="demean",
                   ignored_columns=ig)
    r["cum_pve_50"] = float(pm.cum_pve[-1])
    glrm_kw = {"quadratic": dict(k=10, loss="quadratic", max_iterations=30),
               "huber_l1": dict(k=10, loss="huber", regularization_x="l1", gamma_x=0.1,
                                max_iterations=10)}
    for name, kw in glrm_kw.items():
        gm, r, _ = fit(f"glrm_{name}_mnist", GLRM, glrm_fr, seed=seed,
                       ignored_columns=ig, score=glrm_fr.rows(slice(0, export_rows)), **kw)
        r.update(objective=gm.objective, step_size=gm.step_size)
        if not np.isfinite(gm.objective):
            raise AssertionError(f"glrm {name}: the objective is not finite")
    # the airlines-shaped frame
    nb, r, _ = fit("naive_bayes_airlines", NaiveBayes, airlines,
                   response_column="IsDepDelayed", laplace=1.0)
    r["auc"] = float(nb.training_metrics.auc)
    if not (np.isfinite(r["auc"]) and r["auc"] > 0.5):
        raise AssertionError(f"naive bayes: AUC {r['auc']}")
    for r in rec["fits"]:
        print(f"breadth fit: {json.dumps(r)}", flush=True)
    # a fit's design is placed once per (frame, design parameters, device)
    cache = devcache_counts("kmeans_x") | devcache_counts("pca_x")
    rec["devcache"] = {k: [cache[k][0] - cache0.get(k, (0, 0))[0],
                           cache[k][1] - cache0.get(k, (0, 0))[1]] for k in cache}
    if rec["devcache"] != {"kmeans_x": [1, 1], "pca_x": [1, 2]}:
        raise AssertionError(f"breadth: cache hits and misses {rec['devcache']}")

    # the card against the CPU on the first rows of each frame
    vs = {}
    for label, builder_cls, frame, kw in (
            ("kmeans", KMeans, blobs_sub, dict(k=10, init="plus_plus", max_iterations=10,
                                                seed=seed)),
            ("kmeans_estimate_k", KMeans, blobs_sub, dict(k=10, estimate_k=True, seed=seed)),
            ("pca", PCA, sub, dict(k=10, ignored_columns=["y"])),
            ("svd", SVD, sub, dict(nv=10, ignored_columns=["y"])),
            ("isolation_forest", IsolationForest, sub, dict(seed=seed,
                                                             ignored_columns=["y"])),
            ("ext_isolation_forest_level0", ExtendedIsolationForest, sub,
             dict(ntrees=100, extension_level=0, seed=seed, ignored_columns=["y"])),
            ("ext_isolation_forest_level27", ExtendedIsolationForest, sub,
             dict(ntrees=100, extension_level=27, seed=seed, ignored_columns=["y"])),
            ("pca_k50_demean_mnist", PCA, mnist_fr,
             dict(k=50, transform="demean", ignored_columns=["label"])),
            ("glrm_quadratic_mnist", GLRM, glrm_fr,
             dict(seed=seed, ignored_columns=["label"], **glrm_kw["quadratic"])),
            ("glrm_huber_l1_mnist", GLRM, glrm_fr,
             dict(seed=seed, ignored_columns=["label"], **glrm_kw["huber_l1"])),
            ("naive_bayes", NaiveBayes, airlines.rows(slice(0, sub_rows)),
             dict(response_column="IsDepDelayed", laplace=1.0))):
        pair, v = [], vs.setdefault(label, {})
        # the MNIST-shaped fits above ran on these whole frames already
        model, fitted_on = models.get(label, (None, None))
        card = model if fitted_on is frame else None
        for d in (dev, torch.device("cpu")):
            if card is not None and d == dev:
                pair.append(card)
                continue
            t0 = time.time()
            pair.append(builder_cls(device=str(d), **kw).train(frame))
            if d.type == "cuda":
                torch.cuda.synchronize()
            v[f"{d.type}_train_s"] = time.time() - t0
        a, b = pair
        if label.startswith("kmeans"):
            ok, v["tot_withinss_max_abs_err"] = _close(a.tot_withinss, b.tot_withinss, 1e-4)
            v["k"] = [int(a.centers_std.shape[0]), int(b.centers_std.shape[0])]
            ok = ok and v["k"][0] == v["k"][1]
        elif label.startswith(("pca", "svd")):
            ok, v["eigenvalue_max_abs_err"] = _close(a.std_deviation ** 2,
                                                     b.std_deviation ** 2, 1e-4)
        elif label == "isolation_forest":
            ok = all(np.array_equal(x, y) for x, y in zip(a.trees, b.trees))
            Xs = tree_matrix(a.data_info, frame)
            la, lb = a.mean_path_lengths(Xs), b.mean_path_lengths(Xs)
            v["trees_equal"] = ok
            v["path_lengths_equal"] = bool(np.array_equal(la, lb))
            ok = ok and v["path_lengths_equal"]
        elif label.startswith("ext_"):
            ok = all(np.array_equal(getattr(a, f), getattr(b, f))
                     for f in ("normals", "offsets", "is_split", "correction"))
            v["trees_equal"] = ok
            la = a.predict(frame).col("mean_length").data
            lb = b.predict(frame).col("mean_length").data
            outside = ~np.isclose(la, lb, rtol=1e-5, atol=0.0)
            v["mean_length_max_abs_err"] = float(np.max(np.abs(la - lb)))
            v["rows_outside_rtol_1e-5"] = int(outside.sum())
            # a row parts only where a projection lies within a float32
            # rounding of a threshold: at level 0 the projection is exact.
            # Such a row takes another path in one tree, which moves its
            # mean length by at most that tree's longest path over ntrees
            step = (a.depth + float(a.correction.max())) / a.normals.shape[0]
            v["one_tree_step"] = step
            print(f"breadth {label}: {int(outside.sum())} of {frame.nrows} rows' "
                  f"mean_length outside rtol 1e-5 of the CPU's (max abs err "
                  f"{v['mean_length_max_abs_err']}, one tree's step {step})", flush=True)
            limit = 0 if label.endswith("level0") else 20
            ok = (ok and int(outside.sum()) <= limit
                  and v["mean_length_max_abs_err"] <= step)
        elif label.startswith("glrm"):
            ok, v["objective_max_abs_err"] = _close(a.objective, b.objective, 1e-3)
            v.update(objective=[a.objective, b.objective],
                     iterations=[a.iterations, b.iterations])
        else:
            ok = bool(np.array_equal(a.priors, b.priors)) and all(
                np.array_equal(getattr(a, t)[k], getattr(b, t)[k])
                for t in ("num_mean", "num_sd", "cat_probs") for k in getattr(b, t))
            v["tables_equal"] = ok
        if not ok:
            raise AssertionError(f"breadth {label}: card and CPU differ: {v}")
        for m in pair:
            if m is not card:
                DKV.remove(m.key)
    rec["card_vs_cpu"] = vs
    print(f"breadth card vs cpu: {json.dumps(vs)}", flush=True)

    # MOJOs through the port's genmodel; save and load on the card
    rec["mojo"], rec["persist"] = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (model, frame) in models.items():
            ex = frame.rows(slice(0, export_rows))
            if label in ("kmeans_plus_plus_k10", "pca_k10_standardize", "isolation_forest",
                         "naive_bayes_airlines"):
                t0 = time.time()
                model.download_mojo(f"{tmp}/{label}.zip")
                cols = {c: ex.col(c).data for c in model.data_info.predictor_names}
                for c in cols:
                    col = ex.col(c)
                    if col.domain is not None:
                        cols[c] = np.array([None if k < 0 else col.domain[k]
                                            for k in col.data], dtype=object)
                got = load_mojo(f"{tmp}/{label}.zip").score(cols)
                want = model._predict_raw(ex)
                ok, err = _close(got, want, 1e-6, 1e-5 if label.startswith("pca") else 0.0)
                rec["mojo"][label] = {"s": time.time() - t0, "max_abs_err": err}
                if not ok:
                    raise AssertionError(f"breadth {label}: MOJO scores differ ({err})")
            t0 = time.time()
            blob = persist.dumps_model(model)
            loaded = persist.loads_model(blob, device=dev)
            if loaded.device != dev:
                raise AssertionError(f"breadth {label}: loaded onto {loaded.device}")
            same = persist.dumps_model(loaded) == blob
            for x, y in zip(_breadth_scores(loaded, ex), _breadth_scores(model, ex)):
                same = same and np.array_equal(x, y)
            rec["persist"][label] = {"s": time.time() - t0, "bytes": len(blob)}
            if not same:
                raise AssertionError(f"breadth {label}: save and load changed the bits")
    print(f"breadth mojo: {json.dumps(rec['mojo'])}", flush=True)
    for model, _ in models.values():
        DKV.remove(model.key)
    return rec


def _breadth_scores(model, frame):
    """What a model of this phase gives for a frame: its raw scores, and
    the extended forest's mean lengths too."""
    if hasattr(model, "normals"):
        p = model.predict(frame)
        return [p.col("anomaly_score").data, p.col("mean_length").data]
    return [model._predict_raw(frame)]


def synth_survival(n_rows: int, n_feat: int, seed: int, censored: float = 0.3):
    """Proportional-hazards survival data: N(0,1) covariates ``x0..``,
    event times exponential with hazard exp(x.b), censoring times
    exponential at the rate that censors about ``censored`` of the rows,
    the observed time (``stop``) rounded to 0.01 so that event times tie
    often, ``event`` 1 or 0, and an entry time ``start`` for left
    truncation: 0 for half the rows, below the stop time for the rest."""
    from h2o3_tpu_torch import ColType, Column, Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    b = rng.normal(size=n_feat) * (0.8 / np.sqrt(n_feat))
    lam = np.exp(X.astype(np.float64) @ b)
    lo, hi = 1e-6, 1e6  # the censoring rate r: mean(r / (r + lam)) = censored
    for _ in range(80):
        r = np.sqrt(lo * hi)
        lo, hi = (r, hi) if np.mean(r / (r + lam)) < censored else (lo, r)
    t, c = rng.exponential(1.0 / lam), rng.exponential(1.0 / r, size=n_rows)
    stop = np.round(np.minimum(t, c), 2)
    start = np.where(rng.random(n_rows) < 0.5, 0.0, np.round(rng.random(n_rows) * stop, 2))
    cols = [Column(f"x{j}", X[:, j], ColType.NUM) for j in range(n_feat)]
    cols += [Column("start", start, ColType.NUM), Column("stop", stop, ColType.NUM),
             Column("event", (t <= c).astype(np.float64), ColType.NUM)]
    return Frame(cols)


def synth_corpus(n_tokens: int, n_words: int, seed: int, sent_len: int = 20):
    """A Word2Vec corpus: ``n_tokens`` words drawn Zipf-distributed (rank
    k with probability proportional to 1/k) from ``n_words`` words
    ``w0..``, in sentences of ``sent_len`` with an NA (None) after each,
    as one string column's values."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_words + 1)
    draws = rng.choice(n_words, size=n_tokens, p=p / p.sum())
    words = np.array([f"w{k}" for k in range(n_words)], dtype=object)[draws]
    n_sent = -(-n_tokens // sent_len)
    out = np.full(n_tokens + n_sent, None, dtype=object)
    pos = np.arange(n_tokens)
    out[pos + pos // sent_len] = words
    return out


GAM_KW = dict(family="binomial", response_column="y",
              gam_columns=["x0", "x1", "x2", ["x3", "x4"], "x5"],
              bs=[0, 0, 0, 1, 2], num_knots=[10, 10, 10, 12, 10])


def _word_frame(tokens):
    from h2o3_tpu_torch import ColType, Column, Frame

    return Frame([Column("words", tokens, ColType.STR)])


def _w2v_fit(label, frame, dev, **kw):
    """A Word2Vec fit on ``dev`` with its record (Word2Vec has no predict:
    its scoring pass is ``transform``)."""
    import torch

    from h2o3_tpu_torch import Word2Vec

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Word2Vec(device=str(dev), **kw).train(frame)
    if cuda:
        torch.cuda.synchronize()
    rec = {"fit": label, "device": str(dev), "rows": frame.nrows,
           "train_s": time.time() - t0, "vocabulary": len(model.words),
           "epochs": model.epochs_run, "losses": model.losses,
           "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    return model, rec


def breadth2_phase(higgs, logit, survival, corpus, dev, seed, sub_rows=200_000,
                   gam_sub=200_000, cox_sub=100_000, psvm_rows=200_000,
                   psvm_sub=20_000, w2v_sub=100_000, export_rows=10_000):
    """GAM, CoxPH, PSVM and Word2Vec on ``dev`` at the full width of their
    frames. On the HIGGS-shaped frame: a binomial GAM with x0, x1, x2 as
    cubic regression splines (10 knots), [x3, x4] as one thin-plate
    smoother (12 knots) and x5 as a monotone I-spline, at lambda 0 and
    again with alpha 0.5, lambda 1e-4 (the ADMM path; its design a
    ``gam_design`` cache hit); a gaussian GAM on the frame's logit with
    M-splines for x0, x1, x2 and the same thin-plate and I-spline; a
    binomial GAM with the three cubic regression splines alone on the
    first ``sub_rows`` rows, whose C POJO, built with the host's C
    compiler, scores ``export_rows`` rows inside the knots as ``predict``
    does (rtol 1e-10). On the survival frame (``synth_survival``): CoxPH with efron and with breslow ties and
    a left-truncated efron fit (``start_column``), with the device memory
    peak. On the first ``psvm_rows`` rows of the HIGGS-shaped frame: PSVM
    at its defaults (rank sqrt(n), gamma 1/28), its support-vector count
    and training AUC. On the corpus (``synth_corpus``): Word2Vec at its
    defaults twice, the vectors of the two runs equal bit for bit,
    ``find_synonyms`` and ``transform("average")``. Scoring passes run on
    the first ``sub_rows`` rows.

    Then each family on the CPU against the card: the binomial GAM on the
    first ``gam_sub`` rows (coefficients rtol 1e-4, atol 1e-6 times the
    largest coefficient's size; iterations equal), efron CoxPH on the
    first ``cox_sub`` rows (coefficients rtol 1e-3, log-likelihood rtol
    1e-5), PSVM on the first ``psvm_sub`` rows (the support sets equal
    where no alpha lies within 1e-5 of ``sv_threshold``, the decision
    function atol 1e-4), Word2Vec on the corpus's first ``w2v_sub`` tokens
    for one epoch (vectors rtol 1e-4 / atol 1e-5). The MOJO export of each
    model raises the JAX package's ``ValueError``, and the first model of
    each family (the binomial GAM, efron CoxPH, PSVM, Word2Vec) is saved
    and loaded on ``dev`` with the same bits and bytes. Every check raises.
    Returns the phase's record."""
    import ctypes
    import tempfile

    import torch

    from h2o3_tpu_torch import GAM, PSVM, CoxPH, ColType, Column
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models import persist
    from h2o3_tpu_torch.models import psvm as psvm_mod
    from h2o3_tpu_torch.models.data_info import expand_matrix

    dev = torch.device(dev)
    rec = {"fits": []}
    models = {}
    cache0 = devcache_counts("gam_design")

    def fit(label, builder_cls, frame, **kw):
        model, r, pred = breadth_fit(label, builder_cls, frame, dev, **kw)
        models[label] = (model, frame)
        rec["fits"].append(r)
        return model, r, pred

    def head(frame, n):
        return frame.rows(slice(0, min(n, frame.nrows)))

    # GAM on the HIGGS-shaped frame
    sub = head(higgs, sub_rows)
    for label, kw in (("gam_binomial", dict(lambda_=0.0)),
                      ("gam_binomial_admm", dict(alpha=0.5, lambda_=1e-4))):
        gam, r, _ = fit(label, GAM, higgs, score=sub, **GAM_KW, **kw)
        r.update(coefficients=len(gam.coefficients), auc=float(gam.training_metrics.auc),
                 residual_deviance=gam.residual_deviance)
        if not (np.all(np.isfinite(gam.beta)) and r["auc"] > 0.5):
            raise AssertionError(f"{label}: AUC {r['auc']}, coefficients finite "
                                 f"{np.all(np.isfinite(gam.beta))}")
    gauss = higgs.drop("y").add_column(Column("logit", logit.astype(np.float64), ColType.NUM))
    gam, r, _ = fit("gam_gaussian_mspline", GAM, gauss, score=head(gauss, sub_rows),
                    family="gaussian", response_column="logit",
                    gam_columns=GAM_KW["gam_columns"], bs=[3, 3, 3, 1, 2],
                    num_knots=GAM_KW["num_knots"])
    r.update(coefficients=len(gam.coefficients), residual_deviance=gam.residual_deviance,
             null_deviance=gam.null_deviance)
    if not gam.residual_deviance < gam.null_deviance:
        raise AssertionError(f"gam gaussian: deviance {gam.residual_deviance} not below "
                             f"the null deviance {gam.null_deviance}")
    cr, r, _ = fit("gam_binomial_cr", GAM, sub, family="binomial",
                   response_column="y", gam_columns=["x0", "x1", "x2"], num_knots=10)
    r["auc"] = float(cr.training_metrics.auc)
    cache = devcache_counts("gam_design")
    rec["devcache"] = [cache["gam_design"][i] - cache0.get("gam_design", (0, 0))[i]
                       for i in (0, 1)]
    if rec["devcache"] != [1, 3]:
        raise AssertionError(f"gam: design cache hits and misses {rec['devcache']}, "
                             "not [1, 3]")
    # the C POJO on rows inside every smoother's knots
    inside = np.ones(sub.nrows, dtype=bool)
    for s in cr.specs:
        x = sub.col(s.column).data
        inside &= (x >= s.knots[0]) & (x <= s.knots[-1])
    rows = sub.rows(np.flatnonzero(inside)[:export_rows])
    Xl, _ = expand_matrix(cr.data_info, rows, dtype=np.float64)
    Xp = np.concatenate([Xl, np.stack([rows.col(s.column).data for s in cr.specs], 1)], 1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        lib = compile_pojo(cr.pojo("c"), tmp, row_type=ctypes.c_double)
        got = pojo_scores(lib, Xp, 3, dtype=np.float64)
        want = cr._predict_raw(rows)
        ok, err = _close(got[:, 1:], want, 1e-10, 1e-12)
        rec["pojo"] = {"rows": rows.nrows, "s": time.time() - t0, "max_abs_err": err}
        if not ok:
            raise AssertionError(f"gam pojo: scores differ from predict ({err})")

    # CoxPH on the survival frame
    for label, kw in (("coxph_efron", dict(ties="efron", ignored_columns=["start"])),
                      ("coxph_breslow", dict(ties="breslow", ignored_columns=["start"])),
                      ("coxph_efron_truncated", dict(ties="efron", start_column="start"))):
        cox, r, _ = fit(label, CoxPH, survival, score=head(survival, sub_rows),
                        response_column="event", stop_column="stop", **kw)
        r.update(loglik=cox.loglik, loglik_null=cox.loglik_null,
                 concordance=cox.concordance, n_events=cox.n_events)
        if not (np.isfinite(cox.loglik) and cox.loglik > cox.loglik_null
                and cox.concordance > 0.5):
            raise AssertionError(f"{label}: loglik {cox.loglik} (null {cox.loglik_null}), "
                                 f"concordance {cox.concordance}")
    # PSVM on the first rows of the HIGGS-shaped frame
    psvm_fr = head(higgs, psvm_rows)
    svm, r, _ = fit("psvm", PSVM, psvm_fr, response_column="y")
    r.update(svs_count=svm.svs_count, bounded_svs_count=svm.bounded_svs_count,
             rank=svm.rank_, gamma=svm.gamma_, auc=float(svm.training_metrics.auc))
    if not (svm.svs_count > 0 and r["auc"] > 0.5):
        raise AssertionError(f"psvm: {svm.svs_count} support vectors, AUC {r['auc']}")
    # Word2Vec on the corpus, twice: the same bits
    words = _word_frame(corpus)
    runs = []
    for i in range(2):
        w2v, r = _w2v_fit(f"word2vec_run{i + 1}", words, dev, seed=seed)
        runs.append(w2v)
        rec["fits"].append(r)
    models["word2vec"] = (runs[0], words)
    same = bool(torch.equal(torch.from_numpy(runs[0].vectors),
                            torch.from_numpy(runs[1].vectors)))
    r.update(vectors_equal_run1=same, synonyms_w0=runs[0].find_synonyms("w0", 10))
    if not same:
        raise AssertionError("word2vec: two seeded runs on the card gave different vectors")
    t0 = time.time()
    avg = runs[0].transform(_word_frame(corpus[: w2v_sub]), "average")
    r["transform_average_rows_per_s"] = w2v_sub / (time.time() - t0)
    if avg.ncols != 100 or not np.isfinite(avg.col("V1").data).any():
        raise AssertionError("word2vec: transform('average') gave no finite vectors")
    DKV.remove(runs[1].key)
    for r in rec["fits"]:
        print(f"breadth2 fit: {json.dumps(r)}", flush=True)

    # the card against the CPU on the first rows of each frame
    vs = {}
    alphas = []
    orig_qp = psvm_mod._solve_box_qp

    def spy_qp(*a, **kw):
        out = orig_qp(*a, **kw)
        alphas.append(out.cpu().numpy())
        return out

    for label, builder_cls, frame, kw in (
            ("gam_binomial", GAM, head(higgs, gam_sub), dict(GAM_KW, lambda_=0.0)),
            ("coxph_efron", CoxPH, head(survival, cox_sub),
             dict(response_column="event", stop_column="stop", ignored_columns=["start"])),
            ("psvm", PSVM, head(higgs, psvm_sub), dict(response_column="y")),
            ("word2vec", None, _word_frame(corpus[: w2v_sub + w2v_sub // 20]),
             dict(epochs=1, seed=seed))):
        pair, v = [], vs.setdefault(label, {})
        alphas.clear()
        psvm_mod._solve_box_qp = spy_qp
        try:
            for d in (dev, torch.device("cpu")):
                t0 = time.time()
                if builder_cls is None:
                    pair.append(_w2v_fit(label, frame, d, **kw)[0])
                else:
                    pair.append(builder_cls(device=str(d), **kw).train(frame))
                if d.type == "cuda":
                    torch.cuda.synchronize()
                v[f"{d.type}_train_s"] = time.time() - t0
        finally:
            psvm_mod._solve_box_qp = orig_qp
        a, b = pair
        if label == "gam_binomial":
            scale = max(1.0, float(np.abs(b.beta).max()))
            ok, v["coef_max_abs_err"] = _close(a.beta, b.beta, 1e-4, 1e-6 * scale)
            v["iterations"] = [a.iterations, b.iterations]
            ok = ok and a.iterations == b.iterations
        elif label == "coxph_efron":
            ok, v["coef_max_abs_err"] = _close(a.beta, b.beta, 1e-3)
            ok2, v["loglik_abs_err"] = _close(a.loglik, b.loglik, 1e-5)
            v.update(loglik=[a.loglik, b.loglik], iterations=[a.iterations, b.iterations])
            ok = ok and ok2
        elif label == "psvm":
            # the support sets agree on every row whose alpha is not within
            # 1e-5 of the threshold on either device
            thr = b.params.sv_threshold
            far = (np.abs(alphas[0] - thr) >= 1e-5) & (np.abs(alphas[1] - thr) >= 1e-5)
            masks = [al > thr for al in alphas]
            v.update(svs=[a.svs_count, b.svs_count], alphas_near_threshold=int((~far).sum()),
                     alpha_max_abs_err=float(np.max(np.abs(alphas[0] - alphas[1]))))
            ok = (np.array_equal(masks[0][far], masks[1][far])
                  and [a.svs_count, b.svs_count] == [int(m.sum()) for m in masks])
            ok2, v["decision_max_abs_err"] = _close(a.decision_function(frame),
                                                    b.decision_function(frame), 0.0, 1e-4)
            ok = ok and ok2
        else:
            ok = a.words == b.words
            ok2, v["vectors_max_abs_err"] = _close(a.vectors, b.vectors, 1e-4, 1e-5)
            ok = ok and ok2
        if not ok:
            raise AssertionError(f"breadth2 {label}: card and CPU differ: {v}")
        for m in pair:
            DKV.remove(m.key)
    rec["card_vs_cpu"] = vs
    print(f"breadth2 card vs cpu: {json.dumps(vs)}", flush=True)

    # no MOJO for these families (the JAX package's ValueError); save and
    # load on the card
    rec["persist"] = {}
    for label, (model, frame) in models.items():
        try:
            model.download_mojo("unused.zip")
        except ValueError as e:
            if str(e) != f"MOJO export not supported for {type(model).__name__}":
                raise
        else:
            raise AssertionError(f"breadth2 {label}: a MOJO was written")
        if label not in ("gam_binomial", "coxph_efron", "psvm", "word2vec"):
            continue  # one model of each family through save and load
        t0 = time.time()
        blob = persist.dumps_model(model)
        loaded = persist.loads_model(blob, device=dev)
        if loaded.device != dev:
            raise AssertionError(f"breadth2 {label}: loaded onto {loaded.device}")
        same = persist.dumps_model(loaded) == blob
        for x, y in zip(_breadth2_scores(loaded, frame, export_rows),
                        _breadth2_scores(model, frame, export_rows)):
            same = same and np.array_equal(x, y)
        rec["persist"][label] = {"s": time.time() - t0, "bytes": len(blob)}
        if not same:
            raise AssertionError(f"breadth2 {label}: save and load changed the bits")
    for model, _ in models.values():
        DKV.remove(model.key)
    return rec


def _breadth2_scores(model, frame, n):
    """What a model of the breadth2 phase gives for the first ``n`` rows
    of its frame: Word2Vec its vectors, the others their raw scores."""
    if hasattr(model, "vectors"):
        return [model.vectors]
    return [model._predict_raw(frame.rows(slice(0, min(n, frame.nrows))))]


def dispatch_probe(dev, threads=4, steps=2_000, repeats=3):
    """Microseconds a small call takes, issued from one thread and from
    ``threads`` threads at once (the median of ``repeats`` runs after one
    to warm up), for three calls that each let go of the GIL and take it
    back: a small PyTorch op on ``dev`` and on CPU tensors (three ops a
    step on 16 values), and ``hashlib.sha1`` of 4 KB, which touches no
    PyTorch. If all three cost more each from many threads, the threads
    wait on one another at the GIL, not in PyTorch or the port."""
    import hashlib
    import statistics
    import threading

    import torch

    def ops(device):
        def work():
            x = torch.zeros(16, device=device)
            for _ in range(steps):
                x = torch.where(x > 0, x, x + 1.0)
        return work

    block = bytes(4096)

    def digests():
        for _ in range(steps):
            for _ in range(3):
                hashlib.sha1(block)

    out = {}
    for name, work in (("card_op", ops(dev)), ("cpu_op", ops(torch.device("cpu"))),
                       ("sha1_4k", digests)):
        for n in (1, threads):
            times = []
            for _ in range(repeats + 1):
                pool = [threading.Thread(target=work) for _ in range(n)]
                t0 = time.perf_counter()
                for t in pool:
                    t.start()
                for t in pool:
                    t.join()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) / (n * steps * 3) * 1e6)
            out[f"{name}_us_{n}_threads"] = statistics.median(times[1:])
    return out


def replay_parted_segments(frame, segments, models, params):
    """Fit ``segments`` of ``frame`` again on the card (one GBM each, with
    ``params``) and check each step whose float order depends on the
    device: every tree's gradients within 1e-6 of the CPU's on the same
    margins (the sigmoid), every level's B1 histogram equal to
    ``hist_chunked_ordered_reference`` on the same inputs, bit for bit, and
    the CPU's ``_split_search`` on that histogram against the card's: each
    node picks the card's (feature, bin, NA direction), or a tie, whose
    best gain is the card's within 1e-5 times max(1, gain). The refits must
    give ``models``' trees, every node and leaf. Returns the trees, levels
    and nodes checked, how many of them differ from the CPU's, and the
    first pick that differs."""
    import torch

    from h2o3_tpu_torch import GBM
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models.segments import SegmentModelsBuilder
    from h2o3_tpu_torch.models.tree import booster
    from h2o3_tpu_torch.ops import cuda_build
    from h2o3_tpu_torch.ops import histogram as hmod
    from h2o3_tpu_torch.ops.cuda_histogram import hist_chunked_ordered_reference

    def host(v):
        return v.cpu() if torch.is_tensor(v) else v

    tally = {"trees": 0, "trees_gradients_differ": 0, "max_gradient_gap": 0.0,
             "levels": 0, "levels_gains_differ": 0, "nodes": 0, "tie_picks": 0,
             "max_tie_gain_gap": 0.0, "first_tie": None}
    codes = {}
    grad_hess = booster.grad_hess_device
    # the booster builds each level through build_histogram_sharded, which
    # calls ops/histogram.build_histogram
    build_histogram, split_search = hmod.build_histogram, booster._split_search

    def checked_gradients(objective, y, margin):
        out = grad_hess(objective, y, margin)
        mine = grad_hess(objective, y.cpu(), margin.cpu())
        gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(out, mine))
        if not gap <= 1e-6:
            raise AssertionError(f"breadth3 segments replay: gradients {gap} apart")
        tally["trees"] += 1
        tally["trees_gradients_differ"] += gap > 0
        tally["max_gradient_gap"] = max(tally["max_gradient_gap"], gap)
        return out

    def checked_histogram(bins_fm, nodes, g, h, n_nodes, n_bins1, rw=None, **kw):
        before = cuda_build.LAUNCHES["hist_nodematmul"]
        out = build_histogram(bins_fm, nodes, g, h, n_nodes, n_bins1, rw=rw, **kw)
        if cuda_build.LAUNCHES["hist_nodematmul"] != before + 1:
            raise AssertionError("breadth3 segments replay: a level did not launch B1")
        want = hist_chunked_ordered_reference(
            codes.setdefault(bins_fm.data_ptr(), bins_fm.cpu()), nodes.cpu(), g.cpu(),
            h.cpu(), n_nodes, n_bins1, rw=host(rw), dtype=kw.get("dtype", "f32"))
        if not torch.equal(out.cpu(), want):
            raise AssertionError(f"breadth3 segments replay: B1 is not its ordered plain "
                                 f"version at level {tally['levels']}")
        tally["levels"] += 1
        return out

    def checked_split(hist, *args, **kw):
        out = split_search(hist, *args, **kw)
        mine = split_search(hist.cpu(), *map(host, args),
                            **{k: host(v) for k, v in kw.items()})
        card = [host(v) for v in out[:4]]
        tally["levels_gains_differ"] += not torch.equal(card[3], mine[3])
        differ = ((card[0] != mine[0]) | (card[1] != mine[1]) | (card[2] != mine[2])).nonzero()
        tally["nodes"] += hist.shape[0]
        for k in differ[:, 0].tolist():
            g_card, g_cpu = float(card[3][k]), float(mine[3][k])
            if g_card == g_cpu == float("-inf"):
                continue  # no candidate: the node splits on neither device
            gap = abs(g_card - g_cpu)
            tie = {"level": tally["levels"] - 1, "node": k, "gains": [g_card, g_cpu],
                   "card": [int(card[0][k]), int(card[1][k]), bool(card[2][k])],
                   "cpu": [int(mine[0][k]), int(mine[1][k]), bool(mine[2][k])]}
            if not gap <= 1e-5 * max(1.0, abs(g_card)):
                raise AssertionError(f"breadth3 segments replay: not a tie: {tie}")
            tally["tie_picks"] += 1
            tally["max_tie_gain_gap"] = max(tally["max_tie_gain_gap"], gap)
            tally["first_tie"] = tally["first_tie"] or tie
        return out

    builder = SegmentModelsBuilder(GBM, params, ["UniqueCarrier"])
    rows = np.zeros(frame.nrows, dtype=bool)
    for seg in segments:
        rows |= builder._segment_mask(frame, seg)
    hooks = (checked_gradients, checked_histogram, checked_split)
    booster.grad_hess_device, hmod.build_histogram, booster._split_search = hooks
    try:
        again = builder.train(frame.rows(rows))
    finally:
        booster.grad_hess_device, hmod.build_histogram, booster._split_search = (
            grad_hess, build_histogram, split_search)
    if any(again.errors):  # a segment's fit keeps its error, a check's too
        raise AssertionError(f"breadth3 segments replay: {again.errors}")
    if again.segments != segments:
        raise AssertionError("breadth3 segments replay: other segments")
    for seg, ma, mb in zip(segments, models, again.models):
        for ta, tb in zip(ma.booster.trees_per_class, mb.booster.trees_per_class):
            for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
                if not np.array_equal(np.stack(getattr(ta, f)), np.stack(getattr(tb, f))):
                    raise AssertionError(f"breadth3 segments replay {seg}: the refit's {f} "
                                         "differs from the first fit's")
        DKV.remove(mb.key)
    return tally


def breadth3_phase(higgs, airlines, dev, seed, rf_rows=100_000, rf_sub=20_000,
                   seg_sub=100_000, pipe_rows=200_000, ref_rows=2_000, seg_trees=10,
                   agg_rows=200_000):
    """Aggregator, RuleFit, segment models, Generic, Assembly with the
    scoring pipeline, and the reference-format MOJO on ``dev``, through the
    port's entry points.

    Aggregator at its defaults on the first ``agg_rows`` rows of the
    HIGGS-shaped features (``higgs`` without its response; cut from every
    row for the script's time: the exemplars stop at the same radius from
    100,000 rows up, ROADMAP C8): the counts sum to the rows, the exemplar
    rows are distinct, the output frame holds ``counts`` and every
    predictor.
    RuleFit at its defaults (GBM rules of length 3, 50 trees,
    ``rules_and_linear``) on the first ``rf_rows`` rows, then again with
    ``algorithm="drf"``: each fit launches B1 exactly once per level of
    every tree its ensembles hold (and no other kernel). One GBM per
    ``UniqueCarrier`` segment of ``airlines`` (its NA segment included) at
    GBM's defaults but for ``seg_trees`` trees, on four worker threads and
    serially: every status ``succeeded``, each segment's trees equal on the
    two runs (every node and leaf), and the serial run's launches those its
    trees imply. One segment's model through its MOJO and ``import_mojo``
    (``Generic``), on the first ``pipe_rows`` rows, against its ``predict``
    (rtol 1e-4, atol 1e-5). An Assembly (``log1p`` of Distance,
    CRSArrTime - CRSDepTime, a column selection) on the first
    ``pipe_rows`` rows, a GBM (``seg_trees`` trees) fitted on its output,
    and their ``ScoringPipeline`` through ``to_bytes``/``from_bytes``:
    ``transform`` of the raw rows against the model's ``predict`` on the
    assembled rows (rtol 1e-4, atol 1e-5), a transform-only pipeline equal
    to ``Assembly.fit`` bit for bit, ``to_java`` with one ``out[j]`` per
    output column. The reference-format MOJO (``models/mojo_ref.py``) of
    that GBM, of RuleFit's DRF ensemble and of its inner GLM, read back by
    ``read_mojo``: ``score0`` on ``ref_rows`` rows against the card's
    predictions (rtol 1e-4, atol 1e-5). Card against CPU (the CPU's trees
    with the card's histogram subtraction): RuleFit on the first ``rf_sub``
    rows (the same rules, coefficients rtol 1e-4 / atol 1e-4 times the
    largest coefficient's size, at least 1: the LASSO stops at
    ``beta_epsilon`` 1e-4; AUC within 1e-4), the segment GBMs on the first
    ``seg_sub`` airlines rows: each segment whose trees split alike on
    both devices within 1e-4 of AUC, and each segment whose trees part
    (at ties, ROADMAP C2) fitted again on the card with every level held
    by ``replay_parted_segments``. Every check raises. Returns the phase's
    record, with the checked fits' kernel launches under ``launches``."""
    import tempfile

    import torch

    from h2o3_tpu_torch import GBM, Aggregator, RuleFit, import_mojo
    from h2o3_tpu_torch.frame.devcache import DEVCACHE
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models import assembly as asm_mod
    from h2o3_tpu_torch.models import mojo_ref
    from h2o3_tpu_torch.models import pipeline as pipe_mod
    from h2o3_tpu_torch.models import rulefit as rulefit_mod
    from h2o3_tpu_torch.models.segments import SegmentModelsBuilder
    from h2o3_tpu_torch.models.tree.common import tree_matrix
    from h2o3_tpu_torch.models.tree.gbm import GBMParameters
    from h2o3_tpu_torch.ops import cuda_build

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    y_air = "IsDepDelayed"
    rec = {"parts": {}}
    launches = {k: 0 for k in cuda_build.KERNELS}

    def head(frame, n):
        return frame.rows(slice(0, min(n, frame.nrows)))

    def cache_totals():
        kinds = DEVCACHE.stats()["kinds"]
        return (sum(v["hits"] for v in kinds.values()),
                sum(v["misses"] for v in kinds.values()))

    class part:
        """One part of the phase: its seconds, device frame cache hits and
        misses, and device memory peak, in ``rec["parts"][name]``."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            self.cache0, self.t0 = cache_totals(), time.time()
            self.rec = rec["parts"].setdefault(self.name, {})
            return self.rec

        def __exit__(self, *exc):
            if cuda:
                torch.cuda.synchronize()
            h, m = cache_totals()
            self.rec.update(s=time.time() - self.t0, cache_hits=h - self.cache0[0],
                            cache_misses=m - self.cache0[1],
                            peak_mem_bytes=torch.cuda.max_memory_allocated() if cuda else None)
            return False

    def implied(models):
        """B1 launches the trees imply: one per level of every tree."""
        return sum(t.ntrees * t.max_depth for m in models
                   for t in m.booster.trees_per_class)

    def counted(label, want_of, fn):
        """Run ``fn`` with the launch counts at 0 and check them: B1 as
        ``want_of(result)`` gives, no other kernel."""
        cuda_build.reset_launch_counts()
        out = fn()
        got = dict(cuda_build.LAUNCHES)
        want = {k: 0 for k in cuda_build.KERNELS}
        if cuda:
            want["hist_nodematmul"] = want_of(out)
        if got != want:
            raise AssertionError(f"breadth3 {label}: kernel launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
        return out, got

    def close_or_raise(label, a, b, rtol, atol):
        ok, err = _close(a, b, rtol, atol)
        if not ok:
            raise AssertionError(f"breadth3 {label}: max abs difference {err}")
        return err

    # Aggregator at its defaults on the first agg_rows HIGGS-shaped rows
    feats = head(higgs, agg_rows).drop("y")
    with part("aggregator") as r:
        agg = Aggregator(device=str(dev)).train(feats)
    rows = agg.exemplar_rows
    r.update(rows=feats.nrows, exemplars=int(len(rows)), radius=agg.radius,
             train_s=agg.run_time)
    if not (agg.counts.sum() == feats.nrows and len(np.unique(rows)) == len(rows)
            and agg.output_frame.names == feats.names + ["counts"]
            and agg.output_frame.nrows == len(rows) and agg.device == dev):
        raise AssertionError(f"breadth3 aggregator: counts sum {agg.counts.sum()}, "
                             f"{len(rows)} exemplars, names {agg.output_frame.names}")
    print(f"breadth3 aggregator: {json.dumps(r)}", flush=True)

    # RuleFit at its defaults, GBM then DRF rules; its ensembles and the
    # rules they gave before the support filter are read on the way
    rf_frame = head(higgs, rf_rows)
    ensembles, extracted = [], []
    orig_ensemble, orig_extract = RuleFit._tree_ensemble, rulefit_mod._extract_rules

    def spy_ensemble(self, *a, **kw):
        m = orig_ensemble(self, *a, **kw)
        ensembles.append(m)
        return m

    def spy_extract(*a, **kw):
        out = orig_extract(*a, **kw)
        extracted.append(len(out))
        return out

    RuleFit._tree_ensemble, rulefit_mod._extract_rules = spy_ensemble, spy_extract
    rulefits, inner = {}, {}
    try:
        for algo in ("gbm", "drf"):
            ensembles.clear()
            extracted.clear()
            label = f"rulefit_{algo}"
            with part(label) as r:
                rf, got = counted(label, lambda _: implied(ensembles), lambda: RuleFit(
                    response_column="y", algorithm=algo, seed=seed,
                    device=str(dev)).train(rf_frame))
            rulefits[algo], inner[algo] = rf, list(ensembles)
            nonzero = sum(1 for c in rf.glm.coefficients.values() if c != 0.0)
            r.update(rows=rf_frame.nrows, train_s=rf.run_time, rules_extracted=sum(extracted),
                     rules_kept=len(rf.rules), nonzero_coefficients=nonzero,
                     importance_rows=len(rf.rule_importance),
                     auc=float(rf.training_metrics.auc), launches=got,
                     trees=[m.booster.trees_per_class[0].ntrees for m in ensembles])
            if not (rf.rules and np.isfinite(r["auc"]) and r["auc"] > 0.5
                    and rf.glm.device == dev
                    and all(m.device == dev for m in ensembles)):
                raise AssertionError(f"breadth3 {label}: {r}")
            print(f"breadth3 {label}: {json.dumps(r)}", flush=True)
    finally:
        RuleFit._tree_ensemble, rulefit_mod._extract_rules = orig_ensemble, orig_extract

    # one GBM per carrier, on four threads and serially
    seg_params = GBMParameters(response_column=y_air, ntrees=seg_trees, seed=seed,
                               device=str(dev))
    runs = {}
    for label, par in (("segments_threads4", 4), ("segments_serial", 1)):
        builder = SegmentModelsBuilder(GBM, seg_params, ["UniqueCarrier"], parallelism=par)
        with part(label) as r:
            if par == 1:
                res, got = counted(label, lambda out: implied(out.models),
                                   lambda: builder.train(airlines))
                r["launches"] = got
            else:
                res = builder.train(airlines)
        runs[label] = res
        status = res.as_frame().col("status")
        r.update(rows=airlines.nrows, segments=len(res.segments),
                 statuses=sorted(set(status.domain[c] for c in status.data)),
                 seconds_per_segment=res.run_times)
        if r["statuses"] != ["succeeded"] or not any(s["UniqueCarrier"] is None
                                                     for s in res.segments):
            raise AssertionError(f"breadth3 {label}: {r['statuses']}, errors {res.errors}")
        print(f"breadth3 {label}: {json.dumps(r)}", flush=True)
    a, b = runs["segments_threads4"], runs["segments_serial"]
    if a.segments != b.segments:
        raise AssertionError("breadth3 segments: the two runs found different segments")
    for seg, ma, mb in zip(a.segments, a.models, b.models):
        for ta, tb in zip(ma.booster.trees_per_class, mb.booster.trees_per_class):
            for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
                if not np.array_equal(np.stack(getattr(ta, f)), np.stack(getattr(tb, f))):
                    raise AssertionError(f"breadth3 segments {seg}: the threaded trees' {f} "
                                         "differ from the serial run's")
    rec["parts"]["segments_threads4"]["trees_equal_serial"] = True
    rec["parts"]["segments_threads4"]["dispatch"] = probe = dispatch_probe(dev)
    print(f"breadth3 dispatch: {json.dumps(probe)}", flush=True)

    # Generic: one segment's GBM through its MOJO and import_mojo
    pipe_raw = head(airlines, pipe_rows)
    seg_model = b.models[0]
    with part("generic") as r, tempfile.TemporaryDirectory() as tmp:
        path = seg_model.download_mojo(f"{tmp}/segment.mojo")
        gen = import_mojo(path, model_id="breadth3_generic", device=str(dev))
        t0 = time.time()
        got = gen._predict_raw(pipe_raw)
        r["predict_rows_per_s"] = pipe_raw.nrows / (time.time() - t0)
        r["max_abs_err"] = close_or_raise("generic", got, seg_model._predict_raw(pipe_raw),
                                          1e-4, 1e-5)
        r.update(segment=b.segments[0], rows=pipe_raw.nrows, source_algo=gen.source_algo)
        if gen.device != dev or DKV.get("breadth3_generic") is not gen:
            raise AssertionError(f"breadth3 generic: on {gen.device}, key {gen.key}")
    print(f"breadth3 generic: {json.dumps(r)}", flush=True)

    # Assembly and the scoring pipeline
    steps = [
        {"op": "ColOp", "fun": "log1p", "col": "Distance"},
        {"op": "BinaryOp", "fun": "-", "left": "CRSArrTime", "right": "CRSDepTime",
         "new_col_name": "ArrMinusDep"},
        {"op": "ColSelect", "cols": ["log1p_Distance", "ArrMinusDep", "Year", "Month",
                                     "DayofMonth", "DayOfWeek", "CRSDepTime",
                                     "UniqueCarrier", "Origin", "Dest", y_air]},
    ]
    with part("pipeline") as r:
        asm, assembled = asm_mod.fit_assembly(steps, pipe_raw)
        pgbm, got = counted("pipeline_gbm", lambda m: implied([m]), lambda: GBM(
            response_column=y_air, ntrees=seg_trees, seed=seed,
            device=str(dev)).train(assembled))
        r["launches"] = got
        pipe = pipe_mod.ScoringPipeline.from_bytes(
            pipe_mod.build_pipeline(pgbm, asm).to_bytes())
        t0 = time.time()
        out = pipe.transform(pipe_raw)
        r["transform_rows_per_s"] = pipe_raw.nrows / (time.time() - t0)
        want = pgbm.predict(asm_mod.Assembly(steps=steps).fit(pipe_raw))
        if out.names != want.names:
            raise AssertionError(f"breadth3 pipeline: columns {out.names}, not {want.names}")
        r["max_abs_err"] = max(close_or_raise("pipeline", out.col(c).data, want.col(c).data,
                                              1e-4, 1e-5) for c in want.names[1:])
        # the labels threshold p1 at the training max-F1 threshold, which is
        # one row's own probability: only rows that close to it may part
        p1, thr = want.col(want.names[-1]).data, pgbm.default_threshold()
        parted = out.col("predict").data != want.col("predict").data
        r["labels_parted_at_threshold"] = int(parted.sum())
        if np.any(parted & ~np.isclose(p1, thr, rtol=1e-4, atol=1e-5)):
            raise AssertionError("breadth3 pipeline: labels part away from the threshold")
        only = pipe_mod.ScoringPipeline.from_bytes(
            pipe_mod.build_pipeline(assembly=asm).to_bytes()).transform(pipe_raw)
        fitted = asm_mod.Assembly(steps=steps).fit(pipe_raw)
        if only.names != fitted.names or not all(
                np.array_equal(only.col(c).data, fitted.col(c).data, equal_nan=True)
                for c in fitted.names):
            raise AssertionError("breadth3 pipeline: transform-only is not Assembly.fit")
        java = asm.to_java("AirlinesMunger")
        if [java.count(f"out[{j}] =") for j in range(len(fitted.names))] != [1] * len(
                fitted.names) or f"out[{len(fitted.names)}]" in java:
            raise AssertionError("breadth3 pipeline: to_java does not write each output once")
        r.update(rows=pipe_raw.nrows, in_names=pipe.in_names, out_names=asm.out_names,
                 auc=float(pgbm.training_metrics.auc))
    print(f"breadth3 pipeline: {json.dumps(r)}", flush=True)

    # the reference-format MOJO of the GBM, RuleFit's DRF ensemble and its GLM
    higgs_rows = head(higgs, ref_rows)
    glm = rulefits["gbm"].glm
    rule_rows = rulefits["gbm"]._rule_frame(higgs_rows)
    cases = [
        ("gbm", pgbm, tree_matrix(pgbm.data_info, head(assembled, ref_rows)),
         pgbm._predict_raw(head(assembled, ref_rows))),
        ("drf", inner["drf"][0], tree_matrix(inner["drf"][0].data_info, higgs_rows),
         inner["drf"][0]._predict_raw(higgs_rows)),
        ("glm", glm, np.stack([rule_rows.col(n).data for n in glm.data_info.predictor_names],
                              axis=1), glm._predict_raw(rule_rows)),
    ]
    with part("mojo_ref") as r, tempfile.TemporaryDirectory() as tmp:
        for label, model, X, want in cases:
            path = mojo_ref.write_mojo(model, f"{tmp}/{label}.zip")
            mojo = mojo_ref.read_mojo(path)
            got = np.stack([mojo.score0(X[i].astype(np.float64)) for i in range(len(X))])
            r[label] = {"bytes": os.path.getsize(path),
                        "max_abs_err": close_or_raise(f"mojo_ref {label}", got,
                                                      want.reshape(len(X), -1), 1e-4, 1e-5)}
    print(f"breadth3 mojo_ref: {json.dumps(r)}", flush=True)

    # the card against the CPU, the CPU's trees with the card's subtraction
    # (rehearsed on the CPU, the "card" is the CPU)
    vs = rec["card_vs_cpu"] = {}
    sub = head(higgs, rf_sub)
    pair = []
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.time()
        with tree_subtract_default(True):
            pair.append(RuleFit(response_column="y", seed=seed, device=str(d)).train(sub))
        vs[f"rulefit_{where}_s"] = time.time() - t0
    ra, rb = pair
    if [x.key() for x in ra.rules] != [x.key() for x in rb.rules]:
        raise AssertionError("breadth3 rulefit: the card's rules are not the CPU's")
    # the LASSO stops once no coefficient moves by beta_epsilon (1e-4) in
    # an IRLSM step, so two devices' coefficients agree to 1e-4 of the
    # coefficients' scale, not of each coefficient
    names = list(rb.glm.coefficients)
    ca = np.array([ra.glm.coefficients[k] for k in names])
    cb = np.array([rb.glm.coefficients[k] for k in names])
    scale = max(1.0, float(np.abs(cb).max()))
    vs.update(rulefit_rules=len(ra.rules), rulefit_coef_scale=scale,
              rulefit_iterations=[ra.glm.iterations, rb.glm.iterations],
              rulefit_auc=[float(ra.training_metrics.auc), float(rb.training_metrics.auc)])
    vs["rulefit_coef_max_abs_err"] = close_or_raise("rulefit card vs cpu", ca, cb, 1e-4,
                                                    1e-4 * scale)
    if abs(vs["rulefit_auc"][0] - vs["rulefit_auc"][1]) > 1e-4:
        raise AssertionError(f"breadth3 rulefit: card and CPU AUC {vs['rulefit_auc']}")
    # the segments' GBMs: each segment whose trees split alike on the two
    # devices has its AUCs within 1e-4. The others part at ties (ROADMAP
    # C2): B1 gives its ordered plain version's bits, but the split
    # search's sums over the bins (a scan on the card, a running sum on
    # the CPU) and the sigmoid round differently on the two devices, and
    # two candidates whose gains lie a few float32 steps apart swap. Each
    # such segment is fitted again on the card (the same trees) with every
    # level checked: B1's histogram equal to hist_chunked_ordered_reference
    # on the same inputs, bit for bit, and the CPU's split search on that
    # histogram picking the card's split at every node, or a tie: a split
    # whose gain is the card's best within 1e-5 times max(1, gain)
    seg_rows = head(airlines, seg_sub)
    seg_p, res = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.time()
        seg_p[where] = GBMParameters(response_column=y_air, ntrees=seg_trees, seed=seed,
                                     device=str(d), tree_subtract=True)
        res[where] = SegmentModelsBuilder(GBM, seg_p[where],
                                          ["UniqueCarrier"]).train(seg_rows)
        vs[f"segments_{where}_s"] = time.time() - t0
    if res["card"].segments != res["cpu"].segments:
        raise AssertionError("breadth3 segments: card and CPU found different segments")
    vs["segments"], parted = [], []
    for seg, mc, mp in zip(res["card"].segments, res["card"].models, res["cpu"].models):
        auc = [float(mc.training_metrics.auc), float(mp.training_metrics.auc)]
        same = split_trees_equal(mc, mp)
        vs["segments"].append({"segment": seg["UniqueCarrier"],
                               "rows": int(mc.training_metrics.nobs), "auc": auc,
                               "split_trees_equal": same})
        if not same:
            parted.append(mc)
        elif abs(auc[0] - auc[1]) > 1e-4:
            raise AssertionError(f"breadth3 segments: equal trees, AUCs apart: "
                                 f"{vs['segments'][-1]}")
    vs["segments_trees_parted"] = [r_["segment"] for r_ in vs["segments"]
                                   if not r_["split_trees_equal"]]
    if parted and cuda:
        t0 = time.time()
        vs["segments_parted_replay"] = replay_parted_segments(
            seg_rows, [s for s, r_ in zip(res["card"].segments, vs["segments"])
                       if not r_["split_trees_equal"]], parted, seg_p["card"])
        vs["segments_parted_replay_s"] = time.time() - t0
    print(f"breadth3 card vs cpu: {json.dumps(vs)}", flush=True)
    for m in [ra, rb] + [m for r_ in res.values() for m in r_.models]:
        DKV.remove(m.key)
    for model in [agg, gen, pgbm, *rulefits.values()] + [m for res in runs.values()
                                                         for m in res.models]:
        DKV.remove(model.key)
    rec["launches"] = launches
    return rec


class host_paths:
    """Inside the block the Rapids sort, merge and group-by take their host
    paths: the plain versions their device paths are held to."""

    def __enter__(self):
        from h2o3_tpu_torch.rapids import dist

        self.saved = dist.DIST_SORT_MIN
        dist.DIST_SORT_MIN = 1 << 62
        return self

    def __exit__(self, *exc):
        from h2o3_tpu_torch.rapids import dist

        dist.DIST_SORT_MIN = self.saved


class call_counter:
    """Counts the calls of ``module.name`` inside the block."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def bits_equal(a, b) -> bool:
    """Bitwise float64 equality; a NaN equals a NaN whatever its payload."""
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    if a.shape != b.shape:
        return False
    return not ((a.view(np.uint64) != b.view(np.uint64)) & ~(np.isnan(a) & np.isnan(b))).any()


def frames_equal(a, b) -> bool:
    """Same names, types and domains, and the same values bit for bit."""
    if a.names != b.names:
        return False
    for ca, cb in zip(a.columns, b.columns):
        if ca.type is not cb.type or ca.domain != cb.domain:
            return False
        if ca.data.dtype == object:
            if list(ca.data) != list(cb.data):
                return False
        elif not bits_equal(ca.numeric_view(), cb.numeric_view()):
            return False
    return True


def vals_equal(a, b) -> bool:
    if a.kind != b.kind:
        return False
    if a.is_frame():
        return frames_equal(a.value, b.value)
    if a.kind in (a.STR, a.STRS):
        return a.value == b.value
    return bits_equal(a.value, b.value)


def special_values(seed=11):
    """The special-values operands of the JAX package's fusion parity suite
    (``tests/test_rapids_fusion.py``): div/mod sign rules, inf dividends,
    signed zeros, NaN, then 200 N(0, 10^2) draws with NaNs."""
    a = [1.5, -2.5, np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0, -3.0, 7.25,
         -7.25, 2.0, 1e300, -1e-300, 5.0, -5.5, -1.0, 0.5, -0.25, 9.0]
    b = [2.0, -3.0, 1.0, 2.0, 2.0, -0.0, 0.0, -2.0, np.nan, np.inf,
         -np.inf, 0.5, 1e-300, 1e300, -5.0, 5.5, np.inf, -0.0, 4.0, -9.0]
    rng = np.random.default_rng(seed)
    ra = rng.standard_normal(200) * 10
    rb = rng.standard_normal(200) * 10
    ra[::13] = np.nan
    rb[::17] = np.nan
    return np.concatenate([a, ra]), np.concatenate([b, rb])


def wide_values(n, seed):
    """``n`` float64 values over wide ranges (|x| up to 1e16), with NaN,
    +-inf, signed zeros, integers and halves mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n) * 10.0 ** rng.uniform(-15, 15, n)
    x[::97] = np.round(x[::97])
    x[::89] = np.round(x[::89]) + 0.5
    x[rng.random(n) < 0.01] = np.nan
    x[rng.random(n) < 0.01] = 0.0
    x[rng.random(n) < 0.01] = -0.0
    x[rng.random(n) < 0.005] = np.inf
    x[rng.random(n) < 0.005] = -np.inf
    return x


def parity_expr(name, kind):
    """One fused-region expression over the frame ``pf`` per fusible prim."""
    if kind == "binop":
        return f"({name} (cols_py pf 0) (cols_py pf 1))"
    if kind == "uniop":
        return f"({name} (cols_py pf 0) 0)" if name == "round" else f"({name} (cols_py pf 0))"
    if kind == "ifelse":
        return "(ifelse (> (cols_py pf 0) 0) (cols_py pf 0) (cols_py pf 1))"
    if kind == "select":
        return f"(* ({name} pf [1]) 2)"
    return f"({name} (* (cols_py pf 0) 2))"


def emit_bit_table(dev, seed, n=1_000_000):
    """Every fusible prim's emit on ``dev`` against its host function, on
    the special values and on ``n`` wide values a side: the count of
    values whose bits part (NaN payloads aside), and whether the prim
    fuses on ``dev``'s type."""
    import torch
    from h2o3_tpu_torch import Column, ColType, Frame
    from h2o3_tpu_torch.rapids.prims import FUSIBLE, PRIMS
    from h2o3_tpu_torch.rapids.runtime import Val

    sa, sb = special_values()
    x = np.concatenate([sa, wide_values(n, seed)])
    y = np.concatenate([sb, wide_values(n, seed + 1)])
    y[len(sb)::3] = np.random.default_rng(seed + 2).integers(-5, 6, len(y[len(sb)::3]))
    frame = lambda v: Val.frame(Frame([Column("a", v, ColType.NUM)]))  # noqa: E731
    tx, ty = (torch.from_numpy(v).to(dev) for v in (x, y))
    table = {}
    for name, spec in sorted(FUSIBLE.items()):
        if spec.kind == "binop":
            got, ref = spec.emit(tx, ty), PRIMS[name](None, [frame(x), frame(y)])
        elif spec.kind == "uniop":
            got, ref = spec.emit(tx), PRIMS[name](None, [frame(x)])
        elif spec.kind == "ifelse":
            got = spec.emit(tx, ty, tx * 2)
            ref = PRIMS[name](None, [frame(x), frame(y), frame(x * 2)])
        else:
            continue
        ref, got = ref.value.col(0).data, got.cpu().numpy()
        parted = (ref.view(np.uint64) != got.view(np.uint64)) & ~(np.isnan(ref) & np.isnan(got))
        table[name] = {"parted": int(parted.sum()), "fuses": dev.type in spec.devices}
    return table


def _group_tolerances(dev_fr, host_fr, shift):
    """The device group-by against the host engine: keys and counts equal;
    min and max within one float32 rounding of the value less ``shift``
    (the device rounds the centered values to float32); the moments at
    the JAX package's device-against-host tolerances
    (``tests/test_dist_munging.py``)."""
    out = {}
    for c in ("Origin", "Dest", "nrow"):
        out[c] = bool(np.array_equal(dev_fr.col(c).data, host_fr.col(c).data))
    for c in ("min_Distance", "max_Distance"):
        d, h = dev_fr.col(c).data, host_fr.col(c).data
        ulp = np.spacing(np.abs(h - shift).astype(np.float32)).astype(np.float64)
        out[c] = bool(np.all((np.isnan(d) & np.isnan(h)) | (np.abs(d - h) <= ulp)))
    for c, rtol, atol in (("mean_Distance", 1e-5, 1e-4), ("sum_Distance", 1e-4, 5e-2),
                          ("sd_Distance", 5e-3, 1e-4), ("var_Distance", 1e-2, 1e-4)):
        out[c] = bool(np.allclose(dev_fr.col(c).data, host_fr.col(c).data, rtol=rtol,
                                  atol=atol, equal_nan=True))
    return out


#: fused pipelines over the HIGGS-shaped frame's columns
RAPIDS_PIPELINES = (
    "(ifelse (& (> (cols_py rapids_higgs 0) 0) (<= (cols_py rapids_higgs 1) 0.5)) "
    "(%% (* (cols_py rapids_higgs 2) 7) 3) (%/% (cols_py rapids_higgs 3) 0.25))",
    "(sqrt (abs (- (cols_py rapids_higgs [0 1 2 3 4 5]) (cols_py rapids_higgs 6))))",
    "(sum (* (round (* (cols_py rapids_higgs 7) 10) 0) (cols_py rapids_higgs 8)))",
    "(floor (/ (+ (cols rapids_higgs [9 10 11]) 1) (cols_py rapids_higgs 12)))",
    "(mean (ifelse (is.na (/ (cols_py rapids_higgs 13) (cols_py rapids_higgs 14))) -1 "
    "(sign (- (cols_py rapids_higgs 15) (trunc (cols_py rapids_higgs 16))))))",
)


def rapids_phase(higgs, airlines, dev, seed, emit_rows=1_000_000):
    """The Rapids engine on ``dev`` (``Session(device=dev)``) against the
    plain versions: the interpreter (``fusion=False``) and the host sort,
    merge and group-by (``host_paths``). Returns the phase's record."""
    import torch
    from h2o3_tpu_torch import ColType, Column, Frame
    from h2o3_tpu_torch.compute import mapreduce, quantile
    from h2o3_tpu_torch.frame import devcache
    from h2o3_tpu_torch.frame.rollups import compute_rollups, histogram
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.rapids import Session, dist, exec_rapids, fusion
    from h2o3_tpu_torch.rapids.prims import FUSIBLE

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = {"card_s": {}, "host_s": {}}
    sess = Session(device=dev)
    plain = Session(device=dev, fusion=False)
    keys = []

    def put(key, fr):
        sess.assign(key, fr)
        keys.append(key)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def frame_table_counts():
        c = devcache.DEVCACHE.stats()["kinds"].get("frame_table", {})
        return c.get("hits", 0), c.get("misses", 0)

    # 1. fused pipelines over the HIGGS columns, bitwise against the
    # interpreter; a warm repeat plans nothing and uploads nothing
    put("rapids_higgs", Frame(higgs.columns))
    pipes = []
    for i, expr in enumerate(RAPIDS_PIPELINES):
        ref, host_s = timed(lambda: exec_rapids(expr, plain))
        fused0 = fusion.COUNTS["fused"]
        got, cold_s = timed(lambda: exec_rapids(expr, sess))
        if fusion.COUNTS["fused"] <= fused0:
            raise AssertionError(f"rapids pipeline {i}: did not fuse ({expr})")
        if not vals_equal(ref, got):
            raise AssertionError(f"rapids pipeline {i}: fused result is not the interpreter's bits")
        hits, misses = frame_table_counts()
        plans = mapreduce.plan_stats()["rapids_fusion"]["misses"]
        again, warm_s = timed(lambda: exec_rapids(expr, sess))
        hits2, misses2 = frame_table_counts()
        regions = (fusion.COUNTS["fused"] - fused0) // 2  # regions a run
        # one region reads the frame's own columns alone; an interpreted
        # prim inside makes a new intermediate frame, uploaded each time
        uploaded = regions == 1 and (misses2 != misses or hits2 <= hits)
        if uploaded or mapreduce.plan_stats()["rapids_fusion"]["misses"] != plans:
            raise AssertionError(f"rapids pipeline {i}: the warm repeat planned or uploaded")
        if not vals_equal(got, again):
            raise AssertionError(f"rapids pipeline {i}: warm repeat differs")
        pipes.append({"host_s": host_s, "cold_s": cold_s, "warm_s": warm_s,
                      "regions": regions})
    rec["pipelines"] = pipes
    rec["card_s"]["pipelines_warm"] = sum(p["warm_s"] for p in pipes)
    rec["host_s"]["pipelines"] = sum(p["host_s"] for p in pipes)
    # every fusible prim: its emit on the device against its host function,
    # and its region through the session against the interpreter
    table, rec["card_s"]["emit_table"] = timed(lambda: emit_bit_table(dev, seed, emit_rows))
    sa, sb = special_values()
    put("pf", Frame([Column("a", sa, ColType.NUM), Column("b", sb, ColType.NUM)]))
    for name, spec in sorted(FUSIBLE.items()):
        expr = parity_expr(name, spec.kind)
        fused0 = fusion.COUNTS["fused"]
        got = exec_rapids(expr, sess)
        fused = fusion.COUNTS["fused"] > fused0
        if not vals_equal(exec_rapids(expr, plain), got):
            raise AssertionError(f"rapids prim {name}: fused region is not the interpreter's bits")
        entry = table.setdefault(name, {"parted": 0, "fuses": True})
        entry["region_fused"] = fused
        if entry["fuses"] and entry["parted"]:
            raise AssertionError(f"rapids prim {name} fuses on {dev.type} and parts from "
                                 f"numpy on {entry['parted']} values")
    rec["prims"] = table
    rec["fuse_on_device"] = sorted(n for n, e in table.items() if e["fuses"])
    rec["interpreted_on_device"] = sorted(n for n, e in table.items() if not e["fuses"])
    print(f"rapids: prims fused on {dev.type}: {rec['fuse_on_device']}; "
          f"interpreted: {rec['interpreted_on_device']}", flush=True)

    # 2. sort by [Origin, Distance], Distance descending: the device order
    # is the host lexsort's
    n = airlines.nrows
    air = Frame(airlines.columns + [Column("rid", np.arange(n, dtype=np.float64), ColType.NUM)])
    put("rapids_air", air)
    expr = "(sort rapids_air [8 10] [1 0])"
    with call_counter(dist, "device_lexsort") as calls:
        dev_sorted, rec["card_s"]["sort"] = timed(lambda: exec_rapids(expr, sess).value)
    with host_paths():
        host_sorted, rec["host_s"]["sort"] = timed(lambda: exec_rapids(expr, plain).value)
    if calls.calls != 1 or not np.array_equal(dev_sorted.col("rid").data,
                                              host_sorted.col("rid").data):
        raise AssertionError(f"rapids sort: device order is not the host lexsort's "
                             f"(device calls {calls.calls})")

    # 3. merge all_left with a 300-row Origin lookup: every column equal
    origin = airlines.col("Origin")
    rng = np.random.default_rng(seed + 19)
    weight = rng.normal(size=len(origin.domain))
    weight[::7] = np.nan
    put("rapids_lookup", Frame([
        Column("Origin", np.arange(len(origin.domain), dtype=np.int32), ColType.CAT,
               list(origin.domain)),
        Column("OriginWeight", weight, ColType.NUM)]))
    expr = '(merge rapids_air rapids_lookup 1 0 [] [] "auto")'
    with call_counter(dist, "device_searchsorted_both") as calls:
        dev_merged, rec["card_s"]["merge"] = timed(lambda: exec_rapids(expr, sess).value)
    with host_paths():
        host_merged, rec["host_s"]["merge"] = timed(lambda: exec_rapids(expr, plain).value)
    if calls.calls != 1 or not frames_equal(dev_merged, host_merged):
        raise AssertionError("rapids merge: the device join is not the host's")
    rec["merge_rows"] = dev_merged.nrows

    # 4. group-by [Origin, Dest] with NAs removed: twice the same bits; the
    # host engine at the tolerances; the segment reduction on the card
    # against the same on CPU tensors: counts, min and max equal
    aggs = " ".join(f'"{a}" 10 "rm"' for a in ("nrow", "mean", "sum", "min", "max", "sd", "var"))
    expr = f"(GB rapids_air [8 9] {aggs})"
    with call_counter(dist, "device_group_aggregate") as calls:
        dev_gb, rec["card_s"]["group_by"] = timed(lambda: exec_rapids(expr, sess).value)
        if not frames_equal(dev_gb, exec_rapids(expr, sess).value):
            raise AssertionError("rapids group-by: two calls give different bits")
    with host_paths():
        host_gb, rec["host_s"]["group_by"] = timed(lambda: exec_rapids(expr, plain).value)
    shift = float(np.nanmean(airlines.col("Distance").data))
    held = _group_tolerances(dev_gb, host_gb, shift)
    if calls.calls != 2 or not all(held.values()):
        raise AssertionError(f"rapids group-by against the host engine: {held} "
                             f"(device calls {calls.calls})")
    comp = (airlines.col("Origin").data.astype(np.int64) + 1) * 302 + airlines.col("Dest").data
    inv = np.unique(comp, return_inverse=True)[1]
    vals = airlines.col("Distance").data - shift
    card = dist.device_group_aggregate(inv, vals, int(inv.max()) + 1, dev)
    cpu = dist.device_group_aggregate(inv, vals, int(inv.max()) + 1, "cpu")
    for k in ("count", "min", "max", "nacnt"):
        if not bits_equal(card[k], cpu[k]):
            raise AssertionError(f"rapids group aggregate: {k} differs card against CPU")
    rec["group_by"] = {
        "groups": dev_gb.nrows, "held": held,
        "sum_max_rel_card_cpu": float(np.max(np.abs(card["sum"] - cpu["sum"])
                                             / np.maximum(np.abs(cpu["sum"]), 1e-300))),
        "sum_bits_card_cpu": bits_equal(card["sum"], cpu["sum"])}

    # 5. quantiles of a 2M-row column with NaNs: card and CPU bit for bit
    col = higgs.col("x0").data.copy()
    col[::97] = np.nan
    probs = [0.0, 0.001, 0.5, 0.999, 1.0]
    q_card, rec["card_s"]["quantiles"] = timed(
        lambda: quantile.quantiles(torch.from_numpy(col).to(dev), probs))
    q_cpu, rec["host_s"]["quantiles"] = timed(lambda: quantile.quantiles(col, probs, device="cpu"))
    if not bits_equal(q_card, q_cpu) or not np.allclose(q_card, np.nanquantile(col, probs),
                                                        rtol=1e-12, atol=0):
        raise AssertionError(f"rapids quantiles: card {q_card} CPU {q_cpu}")
    rec["quantiles"] = q_card.tolist()

    # 6. x: N x 28 by 28 x 4 in float32 against float64 numpy, each entry
    # within 1e-4 of the size of its terms
    feats = Frame([higgs.col(f"x{j}") for j in range(28)])
    put("rapids_h28", feats)
    w = rng.normal(size=(28, 4))
    put("rapids_w", Frame([Column(f"w{j}", w[:, j], ColType.NUM) for j in range(4)]))
    expr = "(x rapids_h28 rapids_w)"
    out, rec["card_s"]["mmult_cold"] = timed(lambda: exec_rapids(expr, sess).value.to_numpy())
    _, rec["card_s"]["mmult_warm"] = timed(lambda: exec_rapids(expr, sess).value)
    A = feats.to_numpy()
    ref, rec["host_s"]["mmult"] = timed(lambda: A @ w)
    scale = np.abs(A) @ np.abs(w)
    if not np.all(np.abs(out - ref) <= 1e-4 * scale):
        raise AssertionError("rapids x: the float32 product parts from float64 numpy")
    rec["mmult_max_rel"] = float(np.max(np.abs(out - ref) / scale))

    # 7. rollups of every airlines column against map_reduce on the card
    t0 = time.perf_counter()
    host_roll = {c.name: (compute_rollups(c), histogram(c)) for c in airlines.columns}
    rec["host_s"]["rollups"] = time.perf_counter() - t0
    names = airlines.names

    def moments(cols, mask):
        out = {}
        for name in names:
            x = cols[name]
            ok = mask & ~torch.isnan(x)
            out[name] = torch.stack([
                ok.sum().double(), (ok & (x == 0)).sum().double(),
                torch.where(ok, x, 0.0).sum(),
                torch.where(ok, x, float("inf")).min(),
                torch.where(ok, x, float("-inf")).max(),
                (ok & (torch.floor(x) != x)).sum().double()])
        return out

    def spread(cols, mask, means):
        return {name: torch.where(mask & ~torch.isnan(cols[name]),
                                  cols[name] - means[name], 0.0).square().sum()
                for name in names}

    def dev_histogram(x, lo, hi, nbins=64):
        ok = ~torch.isnan(x)
        # a device tensor divisor: PyTorch divides a CUDA tensor by a host
        # scalar as a product with its reciprocal
        span = torch.tensor(max(hi - lo, 1e-300), dtype=x.dtype, device=x.device)
        idx = torch.clamp(((x[ok] - lo) / span * nbins).to(torch.int64), 0, nbins - 1)
        return torch.bincount(idx, minlength=nbins).cpu().numpy()

    t0 = time.perf_counter()
    m = mapreduce.map_reduce_frame(moments, airlines, columns=names, device=dev)
    table = mapreduce.FrameTable.from_frame(airlines, columns=names, device=dev,
                                            dtype=torch.float64)
    mom = mapreduce.map_reduce(moments, table)
    means = {k: float(v[2] / v[0]) for k, v in mom.items()}
    sq = mapreduce.map_reduce(spread, table, means)
    dev_roll = {}
    for name in names:
        cnt, zero, total, lo, hi, frac = (float(v) for v in mom[name])
        sigma = float(np.sqrt(float(sq[name]) / (cnt - 1)))
        dev_roll[name] = (cnt, zero, means[name], sigma, lo, hi, frac == 0,
                          dev_histogram(table.arrays[name], lo, hi))
    sync()
    rec["card_s"]["rollups"] = time.perf_counter() - t0
    for name, (r, hist) in host_roll.items():
        cnt, zero, mean, sigma, lo, hi, is_int, dhist = dev_roll[name]
        exact = (cnt == n - r.na_count and zero == r.zero_count and lo == r.min
                 and hi == r.max and is_int == r.is_int and np.array_equal(dhist, hist))
        f32 = m[name]  # the float32 table's moments: counts exact, sums near
        if (not exact or not np.isclose(mean, r.mean, rtol=1e-12, atol=0)
                or not np.isclose(sigma, r.sigma, rtol=1e-10, atol=0)
                or float(f32[0]) != cnt or not np.isclose(float(f32[2]) / cnt, r.mean, rtol=1e-4)):
            raise AssertionError(f"rapids rollups of {name}: device {dev_roll[name][:7]} host {r}")
    rec["rollup_columns"] = len(names)

    for key in keys:
        sess.remove(key)
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    rec["device_cache"] = devcache.DEVCACHE.stats()["kinds"].get("frame_table")
    return rec


#: the importances' tolerance, card against CPU (the same model scoring on
#: each device; both take the same rows and permutations from ``--seed``)
PVI_ATOL = 1e-6


def rapids_prims_phase(higgs, airlines, model, dev, seed, str_rows=200_000,
                       small_rows=20_000, ref_rows=2_000, query_rows=100,
                       pvi_rows=100_000):
    """The Rapids prims of ``search``, ``advmath``, ``strings``, ``times``
    and ``models``: host numpy, as in the JAX package, fed by regions that
    fuse on ``dev``. Each expression runs on ``Session(device=dev)`` and on
    a CPU session (``Session(device="cpu")``) with the same bits; where a
    fused region feeds the prim, it fuses on ``dev`` and the interpreter
    (``fusion=False``) gives the same bits too. Results are checked
    against numpy where the check is cheap. ``PermutationVarImp`` of
    ``model`` scores on the card and, for a CPU copy of the model, on the
    CPU: each variable's importance within ``PVI_ATOL``. Returns the phase's
    record, with the histogram launches of its own segment fit (made only
    when no ``SegmentModels`` is left in the DKV) under ``launches``."""
    import tempfile

    import torch
    from h2o3_tpu_torch import GBM, ColType, Column, Frame
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models import persist
    from h2o3_tpu_torch.models.segments import SegmentModels, SegmentModelsBuilder
    from h2o3_tpu_torch.models.tree.gbm import GBMParameters
    from h2o3_tpu_torch.ops import cuda_build
    from h2o3_tpu_torch.rapids import Session, exec_rapids, fusion

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sess = Session(device=dev)
    host = Session(device=torch.device("cpu"))
    plain = Session(device=dev, fusion=False)
    rec = {"card_s": {}, "cpu_s": {}, "prims": [], "checks": {}}
    launches = {k: 0 for k in cuda_build.KERNELS}
    keys, slowest = [], []

    def put(key, fr):
        sess.assign(key, fr)
        keys.append(key)
        return fr

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def run(step, expr, interpreted=False):
        """``expr`` on the card's session and the CPU's: the same bits. With
        ``interpreted``, a region fuses on the card and the interpreter
        gives the same bits."""
        fused0 = fusion.COUNTS["fused"]
        got, card_s = timed(lambda: exec_rapids(expr, sess))
        fused = fusion.COUNTS["fused"] - fused0
        ref, cpu_s = timed(lambda: exec_rapids(expr, host))
        rec["card_s"][step] = rec["card_s"].get(step, 0.0) + card_s
        rec["cpu_s"][step] = rec["cpu_s"].get(step, 0.0) + cpu_s
        slowest.append((card_s, cpu_s, expr[:72]))
        if not vals_equal(got, ref):
            raise AssertionError(f"rapids prims {step}: card and CPU sessions part on {expr}")
        if interpreted and (fused < 1 or not vals_equal(got, exec_rapids(expr, plain))):
            raise AssertionError(f"rapids prims {step}: {expr} fused {fused} regions on the "
                                 f"card, or parts from the interpreter")
        name = expr[1:].split(" ", 1)[0].rstrip(")")
        if name not in rec["prims"]:
            rec["prims"].append(name)
        return got.value

    def check(name, ok, detail=None):
        rec["checks"][name] = detail if detail is not None else bool(ok)
        if not ok:
            raise AssertionError(f"rapids prims: {name} ({detail})")

    n = airlines.nrows
    air = put("rp_air", Frame(airlines.columns))
    dist = airlines.col("Distance").data
    dow = airlines.col("DayOfWeek").data

    # search: each prim fed by a comparison fused on the card, 2M rows
    got = run("search", "(which (& (> (cols_py rp_air 10) 1500) (== (cols_py rp_air 3) 5)))",
              True)
    check("which", np.array_equal(got.col(0).data, np.nonzero((dist > 1500) & (dow == 5))[0]))
    run("search", "(which.max (* (- (cols rp_air [4 5 10]) 1) -1))", True)
    got = run("search", "(which.max (* (cols rp_air [4 5 10]) 2) 1 1)", True)
    check("which.max", got.nrows == n)
    run("search", "(which.min (+ (cols rp_air [4 5 10]) (cols_py rp_air 7)) 1 0)", True)
    run("search", "(which.min (- (cols rp_air [4 5 10]) (cols_py rp_air 7)) 1 1)", True)
    got = run("search", "(match (ifelse (> (cols_py rp_air 10) 1000) (cols_py rp_air 3) -1) "
                        "[5 6 7] 0 1)", True)
    want = np.where(dist > 1000, dow, -1)
    check("match", np.array_equal(got.col(0).data,
                                  np.select([want == 5, want == 6, want == 7], [1.0, 2.0, 3.0],
                                            0.0)))

    # advmath: the HIGGS columns, Origin x Dest, impute by Origin, the
    # random columns, distances, tf-idf and isax at small_rows
    put("rp_higgs", Frame(higgs.columns))
    got = run("advmath", "(cor (cols rp_higgs [0:28]) (cols rp_higgs [0:28]))")
    X = np.stack([higgs.col(f"x{j}").data for j in range(28)], axis=1)
    check("cor", np.allclose(got.to_numpy(), np.corrcoef(X, rowvar=False), rtol=0, atol=1e-12))
    got = run("advmath", "(var (cols rp_higgs [0:28]))")
    check("var", np.allclose(got.to_numpy(), np.cov(X, rowvar=False), rtol=1e-12, atol=1e-15))
    del X
    for expr in ("(skewness (cols_py rp_higgs 0) 1)", "(kurtosis (cols_py rp_higgs 0) 1)",
                 '(hist (cols_py rp_higgs 0) "sturges")', "(hist (cols_py rp_higgs 0) 50)",
                 '(quantile (cols_py rp_higgs 0) [0 0.001 0.25 0.5 0.75 0.999 1] '
                 '"interpolate" _)', "(difflag1 (cols_py rp_higgs 0))",
                 "(unique (cols_py rp_air 8) 1)", "(unique (cols_py rp_air 9) 0)",
                 f"(kfold_column rp_air 5 {seed})", "(modulo_kfold_column rp_air 5)",
                 f"(stratified_kfold_column (cols_py rp_air 11) 5 {seed})",
                 f"(h2o.runif rp_air {seed})"):
        run("advmath", expr)
    got = run("advmath", "(table (cols rp_air [8 9]))")
    ok = (airlines.col("Origin").data >= 0) & (airlines.col("Dest").data >= 0)
    check("table", got.nrows == 300 and got.ncols == 301
          and float(got.to_numpy()[:, 1:].sum()) == float(ok.sum()))
    got = run("advmath", '(h2o.impute rp_air 10 "median" "interpolate" [8] _ _)')
    check("impute", not np.isnan(got.col("Distance").data).any()
          and bits_equal(got.col("Distance").data[~np.isnan(dist)], dist[~np.isnan(dist)]))
    got = run("advmath", f"(h2o.random_stratified_split (cols_py rp_air 11) 0.2 {seed})")
    late = airlines.col("IsDepDelayed").data
    test = got.col(0).data == 1
    check("random_stratified_split", all(abs(test[late == c].sum() - 0.2 * (late == c).sum())
                                         <= 0.5 for c in (0, 1)))
    put("rp_ref", Frame([higgs.col(f"x{j}").select(np.arange(ref_rows)) for j in range(28)]))
    put("rp_query", Frame([Column(f"q{j}", higgs.col(f"x{j}").data[ref_rows:ref_rows
                                                                  + query_rows], ColType.NUM)
                           for j in range(28)]))
    R, Q = sess.lookup("rp_ref").to_numpy(), sess.lookup("rp_query").to_numpy()
    for measure in ("l1", "l2", "cosine", "cosine_sq"):
        got = run("advmath", f'(distance rp_ref rp_query "{measure}")').to_numpy()
        if measure == "l1":
            want = np.abs(R[:, None] - Q[None]).sum(-1)
        elif measure == "l2":
            want = np.sqrt(((R[:, None] - Q[None]) ** 2).sum(-1))
        else:
            cos = (R @ Q.T) / np.outer(np.linalg.norm(R, axis=1), np.linalg.norm(Q, axis=1))
            want = cos if measure == "cosine" else cos * cos
        check(f"distance {measure}", got.shape == (ref_rows, query_rows)
              and np.allclose(got, want, rtol=1e-9, atol=1e-9))
    head = airlines.rows(slice(0, small_rows))
    names = lambda c: np.asarray(c.domain + ["NA"], dtype=object)[c.data]  # noqa: E731
    text = [f"{a} {b} {c} {a}" for a, b, c in zip(names(head.col("Origin")),
                                                 names(head.col("Dest")),
                                                 names(head.col("UniqueCarrier")))]
    put("rp_docs", Frame([Column("doc", np.arange(small_rows, dtype=np.float64) // 10,
                                 ColType.NUM),
                          Column("text", np.array(text, dtype=object), ColType.STR)]))
    got = run("advmath", "(tf-idf rp_docs 0 1 1 0)")
    check("tf-idf", got.nrows > small_rows // 10 and got.names[2:] == ["TF", "IDF", "TF_IDF"])
    put("rp_series", Frame([higgs.col(f"x{j}").select(np.arange(small_rows))
                            for j in range(28)]))
    got = run("advmath", "(isax rp_series 7 16 0)")
    check("isax", got.nrows == small_rows and got.ncols == 8)

    # strings: the STR columns as.character makes of Origin and Dest
    # (str_rows rows), and Origin itself, where the CAT domain is mapped
    put("rp_air_head", airlines.rows(slice(0, str_rows)))
    strs = put("rp_str", run("strings", "(as.character (cols rp_air_head [8 9]))"))
    for expr in ("(tolower rp_str)", "(toupper (tolower rp_str))", "(trim rp_str)",
                 '(lstrip rp_str "A")', '(rstrip rp_str "AB")', '(replaceall rp_str "[AB]" "x" 1)',
                 '(replacefirst rp_str "A" "")', '(strsplit (cols_py rp_str 0) "B")',
                 "(substring rp_str 1 3)", "(length rp_str)", '(grep (cols_py rp_str 0) "^A" 0 0 0)',
                 '(grep (cols_py rp_str 1) "b$" 1 1 1)'):
        run("strings", expr)
    got = run("strings", "(strlen (cols_py rp_str 0))").col(0).data
    check("strlen", np.array_equal(got, np.where(strs.col(0).data == None, np.nan, 3.0),  # noqa: E711
                                   equal_nan=True))
    # the prims that loop over characters or substrings in Python, at small_rows
    put("rp_str_small", strs.rows(slice(0, small_rows)))
    with tempfile.TemporaryDirectory() as tmp:
        words = os.path.join(tmp, "words.txt")
        with open(words, "w") as fh:
            fh.write("\n".join(d for d in airlines.col("Origin").domain[:40]) + "\nAA\nBA\n")
        for expr in ("(entropy rp_str_small)", '(countmatches rp_str_small ["A" "B"])',
                     '(tokenize rp_str_small "A")',
                     f'(num_valid_substrings rp_str_small "{words}")'):
            run("strings", expr)
    for measure in ("lv", "jaccard", "jw"):
        run("strings", f'(strDistance (cols_py rp_str_small 0) (cols_py rp_str_small 1) '
                       f'"{measure}" 1)')
    origin = airlines.col("Origin")
    got = run("strings", "(tolower (cols_py rp_air 8))").col(0)
    check("tolower domain", got.domain == [d.lower() for d in origin.domain])
    got = run("strings", "(substring (cols_py rp_air 8) 0 1)").col(0)
    first = sorted({d[0] for d in origin.domain})
    check("substring collapse", got.domain == first and np.array_equal(
        got.data, np.where(origin.data >= 0, np.searchsorted(
            first, np.asarray([d[0] for d in origin.domain]))[np.maximum(origin.data, 0)], -1)))
    run("strings", "(strlen (cols_py rp_air 8))")

    # times: mktime of str_rows airlines rows (the day clipped to 28, as the
    # synthetic days run to 31 in every month), the UTC fields, as.Date of
    # the same stamps as strings; then one America/New_York round at
    # small_rows and back to UTC
    a = "rp_air_head"
    mk = (f"(mktime (cols_py {a} 0) (- (cols_py {a} 1) 1) (- (ifelse (> (cols_py {a} 2) 28) 28 "
          f"(cols_py {a} 2)) 1) (intDiv (cols_py {a} 4) 100) (%% (cols_py {a} 4) 100) 0 0)")
    stamps = put("rp_time", run("times", mk))
    hd = sess.lookup(a)
    yy, mm = hd.col("Year").data.astype(np.int64), hd.col("Month").data.astype(np.int64)
    dd = np.minimum(hd.col("DayofMonth").data, 28).astype(np.int64)
    dep = hd.col("CRSDepTime").data.astype(np.int64)
    days = ((yy - 1970) * 12 + mm - 1).astype("datetime64[M]").astype("datetime64[D]") + (dd - 1)
    want = (days.astype(np.int64) * 86_400_000 + (dep // 100) * 3_600_000
            + (dep % 100) * 60_000).astype(np.float64)
    check("mktime", bits_equal(stamps.col(0).data, want))
    fields = {"year": yy, "month": mm, "day": dd, "dayOfWeek": None, "hour": dep // 100,
              "minute": dep % 100, "second": 0, "millis": 0, "week": None}
    for field, expect in fields.items():
        got = run("times", f"({field} rp_time)").col(0).data
        if expect is not None:
            check(f"{field} of mktime", bits_equal(got, np.broadcast_to(expect, got.shape)))
    text = np.char.replace(np.datetime_as_string(
        stamps.col(0).data.astype(np.int64).astype("datetime64[ms]").astype("datetime64[m]")),
        "T", " ")
    put("rp_dates", Frame([Column("when", text.astype(object), ColType.STR)]))
    got = run("times", '(as.Date rp_dates "yyyy-MM-dd HH:mm")')
    check("as.Date of the mktime strings", bits_equal(got.col(0).data, want))
    put("rp_time_small", stamps.rows(slice(0, small_rows)))
    put("rp_dates_small", sess.lookup("rp_dates").rows(slice(0, small_rows)))
    put("rp_air_small", hd.rows(slice(0, small_rows)))
    utc_hours = run("times", "(hour rp_time_small)").col(0).data
    try:
        run("times_zone", '(setTimeZone "America/New_York")')
        for field in fields:
            got = run("times_zone", f"({field} rp_time_small)")
            if field == "hour":
                shift = set(((utc_hours - got.col(0).data) % 24).astype(int).tolist())
                check("New York's hours are UTC's less 4 or 5", shift == {4, 5}, sorted(shift))
        run("times_zone", "(getTimeZone)")
        run("times_zone", mk.replace(a, "rp_air_small"), True)
        got = run("times_zone", '(as.Date rp_dates_small "yyyy-MM-dd HH:mm")').col(0).data
        check("as.Date in New York is later than in UTC",
              set(((got - want[:small_rows]) / 3_600_000).tolist()) <= {4.0, 5.0})
    finally:
        exec_rapids('(setTimeZone "UTC")', sess)
    check("the zone is UTC again", exec_rapids("(getTimeZone)", host).value == "UTC")
    run("times", "(listTimeZones)")
    run("times", "(time rp_time)")

    # models: perfectAUC of the model's predictions, its threshold, the
    # segment models' frame, permutation importance card against CPU
    pred = model.predict(higgs)
    y = higgs.col("y").data.astype(np.float64)
    put("rp_pred", Frame([Column("p1", pred.col("p1").data, ColType.NUM),
                          Column("act", y, ColType.NUM)]))
    auc = float(run("models", "(perfectAUC (cols_py rp_pred 0) (cols_py rp_pred 1))")
                .col(0).data[0])
    rec["perfect_auc"] = auc
    check("perfectAUC near the training AUC", abs(auc - model.training_metrics.auc) < 1e-3,
          auc - float(model.training_metrics.auc))
    t0 = float(model.default_threshold())
    old = exec_rapids(f"(model.reset.threshold {model.key} 0.3)", sess).value.col(0).data[0]
    back = exec_rapids(f'(model.reset.threshold "{model.key}" {t0!r})', host).value
    check("model.reset.threshold", old == t0 and back.col(0).data[0] == 0.3
          and model.default_threshold() == t0)
    rec["prims"].append("model.reset.threshold")
    segs = [DKV.get(k) for k in DKV.keys() if isinstance(DKV.get(k), SegmentModels)]
    if segs:
        sm = segs[0]
        rec["segment_models"] = "an earlier phase's"
    else:
        small = sess.lookup("rp_air_small")
        wk = Column("Weekend", (small.col("DayOfWeek").data >= 6).astype(np.int32), ColType.CAT,
                    ["no", "yes"])
        before = dict(cuda_build.LAUNCHES)
        sm = SegmentModelsBuilder(GBM, GBMParameters(response_column="IsDepDelayed", ntrees=5,
                                                     seed=seed, device=str(dev)),
                                  ["Weekend"]).train(small.add_column(wk))
        launches = {k: cuda_build.LAUNCHES[k] - before[k] for k in launches}
        rec["segment_models"] = "its own, two segments"
    got = run("models", f"(segment_models_as_frame {sm.key})")
    status = got.col("status")
    check("segment_models_as_frame", got.nrows == len(sm.segments)
          and {status.domain[c] for c in status.data} == {"succeeded"})
    cpu_model = persist.loads_model(persist.dumps_model(model), key=f"{model.key}_cpu",
                                    register=True, device="cpu")
    pvi = f'"logloss" {pvi_rows} 1 [] {seed}'
    with call_counter(type(model), "_predict_raw") as calls:
        card, rec["card_s"]["pvi"] = timed(lambda: exec_rapids(
            f"(PermutationVarImp {model.key} rp_higgs {pvi})", sess).value)
    cpu, rec["cpu_s"]["pvi"] = timed(lambda: exec_rapids(
        f"(PermutationVarImp {cpu_model.key} rp_higgs {pvi})", host).value)
    DKV.remove(cpu_model.key)
    rec["prims"].append("PermutationVarImp")
    imp_card = dict(zip(card.col(0).data, card.col(1).data))
    imp_cpu = dict(zip(cpu.col(0).data, cpu.col(1).data))
    gap = max(abs(imp_card[v] - imp_cpu[v]) for v in imp_card) if imp_card.keys() == \
        imp_cpu.keys() else np.inf
    order = list(card.col(0).data)
    ordered = all(imp_cpu[a] >= imp_cpu[b] - PVI_ATOL for a, b in zip(order, order[1:]))
    rec["pvi"] = {"rows": pvi_rows, "scorings_on_card": calls.calls, "max_abs_gap": gap,
                  "top": order[:5], "bits_equal": bits_equal(card.col(1).data,
                                                             cpu.col(1).data)}
    if not (calls.calls == 29 and len(order) == 28 and gap <= PVI_ATOL and ordered):
        raise AssertionError(f"rapids prims: PermutationVarImp card against CPU {rec['pvi']}")

    for key in keys:
        sess.remove(key)
    rec["slowest"] = sorted(slowest, reverse=True)[:8]  # (card s, CPU s, expression)
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    rec["launches"] = launches
    return rec


# ---------------------------------------------------------------------------
# the mesh phase: row sharding over torch.distributed (parallel/mesh.py)


def _trees_of(booster):
    """A booster's tree arrays per class and field, as host arrays."""
    return {f: [np.stack(getattr(t, f)) for t in booster.trees_per_class]
            for f in ("feat", "split_bin", "default_left", "is_split", "leaf")}


def _trees_bits_equal(a, b) -> bool:
    return all(len(a[f]) == len(b[f]) and all(
        x.shape == y.shape and x.tobytes() == y.tobytes() for x, y in zip(a[f], b[f]))
        for f in a)


def _splits_equal(a, b) -> bool:
    """Whether two boosters' trees split alike (leaf values aside)."""
    return _trees_bits_equal({f: a[f] for f in a if f != "leaf"},
                             {f: b[f] for f in b if f != "leaf"})


def _merge_ms(pm, mesh, dev, reps=20):
    """ms per float merge (``mesh.psum``) of a level histogram of 32 nodes x
    28 features x 257 bins x 3 on the card, CUDA events around ``reps``."""
    import torch

    h = torch.randn((32, 28, 257, 3), device=dev)
    pm.psum(h, mesh)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pm.psum(h, mesh)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _mesh_fit(builder, frame, X, pm, cuda_build, **kw):
    """One fit through ``.train()`` with the group live, its launches, the
    collectives it issued, and its margins gathered in row order."""
    import torch

    cuda_build.reset_launch_counts()
    pm.reset_counts()
    t0 = time.time()
    model = builder(response_column="y", **kw).train(frame)
    torch.cuda.synchronize()
    rec = {"train_s": time.time() - t0, "launches": dict(cuda_build.LAUNCHES),
           "collectives": dict(pm.COUNTS), "auc": model.training_metrics.auc}
    t0 = time.time()
    margin = model.booster.predict_margin(X)
    rec["predict_s"] = time.time() - t0
    return model, rec, margin


def mesh_part_a(mesh, seed, n_rows, trees):
    """(a), NCCL at world size 1: the XGBoost fit of phase 8 through
    ``.train()`` with the group live."""
    import torch

    from h2o3_tpu_torch import XGBoost
    from h2o3_tpu_torch.ops import cuda_build
    from h2o3_tpu_torch.parallel import mesh as pm

    X, y, _ = synth_higgs(n_rows, 28, seed)
    frame = make_frame(X, y)
    torch.cuda.reset_peak_memory_stats()
    model, rec, margin = _mesh_fit(XGBoost, frame, X, pm, cuda_build, ntrees=trees,
                                   seed=seed)
    rec["merge_ms"] = _merge_ms(pm, mesh, mesh.device)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    return {"xgboost": rec, "trees": _trees_of(model.booster), "margin": margin}


def mesh_part_b(mesh, seed, n_rows, trees, drf_trees, air_rows):
    """(b), two gloo ranks sharing the card (host-staged): the same XGBoost
    fit, its merged root histogram (B1) and a merged level of 128 nodes at
    DRF's 21 bins (B2) against one build over every row, a DRF whose levels
    8-11 take B2 sharded, the sample sort and group-by of the airlines rows
    by [Origin, Dest], and one sharded GLM Gram pass."""
    import hashlib

    import torch

    from h2o3_tpu_torch import DRF, XGBoost
    from h2o3_tpu_torch.models import glm
    from h2o3_tpu_torch.models.tree import booster
    from h2o3_tpu_torch.ops import cuda_build
    from h2o3_tpu_torch.ops.histogram import (apply_bins_device, build_histogram,
                                              build_histogram_sharded, make_bins)
    from h2o3_tpu_torch.parallel import mesh as pm
    from h2o3_tpu_torch.rapids import dist
    from h2o3_tpu_torch.rapids.groupby import group_by

    dev = mesh.device
    out, parts = {}, {}
    X, y, logit = synth_higgs(n_rows, 28, seed)
    frame = make_frame(X, y)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model, rec, margin = _mesh_fit(XGBoost, frame, X, pm, cuda_build, ntrees=trees,
                                   seed=seed)
    levels = trees * (model.booster.trees_per_class[0].max_depth + 1)
    rec["bytes_gathered_per_level"] = rec["collectives"]["bytes_gathered"] / levels
    out.update(trees=_trees_of(model.booster),
               margin_sha1=hashlib.sha1(margin.tobytes()).hexdigest())
    if mesh.rank == 0:
        out["margin"] = margin
    out["xgboost"] = rec
    parts["xgboost_s"] = time.time() - t0

    # the merged root histogram (B1 at one node) against one build of every row
    t0 = time.time()
    edges = make_bins(X, 256, seed=seed)
    f0 = float(np.log(y.mean() / (1 - y.mean())))
    S = mesh.rows(n_rows)[2]
    codes = booster._local_codes(X, edges, dev, mesh)
    yl = torch.from_numpy(pm.local_rows(y.astype(np.float32), mesh)).to(dev)
    g, h = booster.grad_hess_device("bernoulli", yl, torch.full((S, 1), f0, device=dev))
    nodes = torch.where(pm.row_mask(n_rows, S * mesh.size, mesh, dev), 0, -1).int()
    merged = build_histogram_sharded(codes, nodes, g[:, 0].contiguous(),
                                     h[:, 0].contiguous(), 1, 257, mesh)
    yall = torch.from_numpy(y.astype(np.float32)).to(dev)
    ga, ha = booster.grad_hess_device("bernoulli", yall,
                                      torch.full((n_rows, 1), f0, device=dev))
    whole = build_histogram(apply_bins_device(X, edges, dev),
                            torch.zeros(n_rows, dtype=torch.int32, device=dev),
                            ga[:, 0].contiguous(), ha[:, 0].contiguous(), 1, 257)
    m, w_ = merged.cpu().numpy(), whole.cpu().numpy()
    out["root"] = {"counts_equal": bool(np.array_equal(m[..., 2], w_[..., 2])),
                   "max_abs_err": float(np.abs(m - w_).max()),
                   "close": bool(np.allclose(m, w_, rtol=RTOL, atol=ATOL))}
    parts["root_s"] = time.time() - t0

    # a level of the sharded DRF's sorted range: 128 nodes (some rows
    # inactive) at its 21 bins, merged, against one build over every row
    t0 = time.time()
    edges20 = make_bins(X, 20, seed=seed)
    node_all = np.random.default_rng(seed + 30).integers(-1, 128, n_rows).astype(np.int32)
    nodes_l = torch.from_numpy(pm.local_rows(node_all, mesh, fill=-1)).to(dev)
    cuda_build.reset_launch_counts()
    merged = build_histogram_sharded(booster._local_codes(X, edges20, dev, mesh), nodes_l,
                                     g[:, 0].contiguous(), h[:, 0].contiguous(), 128, 21,
                                     mesh)
    whole = build_histogram(apply_bins_device(X, edges20, dev),
                            torch.from_numpy(node_all).to(dev), ga[:, 0].contiguous(),
                            ha[:, 0].contiguous(), 128, 21)
    m, w_ = merged.cpu().numpy(), whole.cpu().numpy()
    out["level"] = {"nodes": 128, "bins": 21, "launches": dict(cuda_build.LAUNCHES),
                    "counts_equal": bool(np.array_equal(m[..., 2], w_[..., 2])),
                    "max_abs_err": float(np.abs(m - w_).max()),
                    "close": bool(np.allclose(m, w_, rtol=RTOL, atol=ATOL))}
    del merged, whole, ga, ha
    parts["level_s"] = time.time() - t0

    t0 = time.time()
    drf, drec, dmargin = _mesh_fit(DRF, frame, X, pm, cuda_build, ntrees=drf_trees,
                                   seed=seed)
    out["drf"] = drec
    out["drf_trees"] = _trees_of(drf.booster)
    out["drf_margin_sha1"] = hashlib.sha1(dmargin.tobytes()).hexdigest()
    parts["drf_s"] = time.time() - t0

    # the sample sort and the group-by of 2,000,000 airlines rows
    t0 = time.time()
    air = synth_airlines(air_rows, seed + 20)
    parts["airlines_synth_s"] = time.time() - t0
    origin, dest = air.col("Origin").data, air.col("Dest").data
    keys = [dist.encode_f64(dest.astype(np.float64)), dist.encode_f64(origin.astype(np.float64))]
    pm.reset_counts()
    t0 = time.time()
    order = dist.device_lexsort(keys)
    parts["sort_s"] = time.time() - t0
    out["sort"] = {"equal": bool(np.array_equal(order, np.lexsort(keys))),
                   "collectives": dict(pm.COUNTS),
                   "sha1": hashlib.sha1(order.tobytes()).hexdigest()}
    names = air.names
    t0 = time.time()
    gb = group_by(air, [names.index("Origin"), names.index("Dest")],
                  [("nrow", 0, "all"), ("mean", names.index("Distance"), "rm"),
                   ("min", names.index("Distance"), "rm"),
                   ("max", names.index("Distance"), "rm")])
    parts["group_by_s"] = time.time() - t0
    pairs = (origin.astype(np.int64) + 1) * 302 + dest.astype(np.int64) + 1
    _, counts = np.unique(pairs, return_counts=True)
    nrow = gb.col("nrow").data
    out["group_by"] = {"groups": int(gb.nrows),
                       "counts_equal": bool(np.array_equal(nrow, counts.astype(np.float64))),
                       "sha1": hashlib.sha1(b"".join(
                           np.ascontiguousarray(c.data).tobytes() for c in gb.columns[2:]))
                       .hexdigest()}

    # one sharded GLM Gram pass against one pass over every row
    t0 = time.time()
    Xi = np.concatenate([X, np.ones((n_rows, 1), np.float32)], axis=1)
    w = np.full(n_rows, 0.25)
    wz = logit + (y - 0.5) * 4.0
    Xd, _ = pm.shard_rows(Xi, mesh)
    G, q = glm._gram(Xd, pm.local_rows(wz, mesh), pm.local_rows(w, mesh), mesh)
    parts["gram_s"] = time.time() - t0
    del Xd
    Xall = torch.from_numpy(Xi).to(dev)
    G1, q1 = glm._gram(Xall, wz, w)
    absX = np.abs(Xi.astype(np.float64))
    G_terms, q_terms = absX.T @ (absX * w[:, None]), absX.T @ np.abs(w * wz)
    out["gram"] = {"ok": bool(np.all(np.abs(G - G1) <= RTOL * G_terms)
                              and np.all(np.abs(q - q1) <= RTOL * q_terms)),
                   "max_rel_err": float(max((np.abs(G - G1) / G_terms).max(),
                                            (np.abs(q - q1) / q_terms).max())),
                   "sha1": hashlib.sha1(G.tobytes() + q.tobytes()).hexdigest()}
    out["merge_ms"] = _merge_ms(pm, mesh, dev)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["parts"] = parts
    return out


def mesh_rank(part, rank, world, backend, device, work, args):
    """One rank of the mesh phase on ``device`` (every rank on the one
    card): join the group, run its part, write the result (or the
    traceback) under ``work``."""
    import pickle
    import traceback

    from h2o3_tpu_torch.parallel import mesh as pm

    t0 = time.time()
    try:
        pm.distributed_initialize(backend=backend, init_method=f"file://{work}/store_{part}",
                                  rank=rank, world_size=world, device=device,
                                  timeout=300)
        body = mesh_part_a if part == "a" else mesh_part_b
        res = {"ok": body(pm.default_mesh(), *args)}
        res["ok"]["rank_s"] = time.time() - t0
    except BaseException:
        res = {"error": traceback.format_exc()}
    finally:
        pm.destroy()
    with open(os.path.join(work, f"{part}_{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def start_mesh_part(part, world, backend, device, work, args):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank,
                         args=(part, r, world, backend, device, work, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return part, procs


def join_mesh_part(started, work, timeout_s=300):
    """Every rank's result of a started part, in rank order; raises with
    the failed ranks' tracebacks. Stops every rank it started."""
    import pickle

    part, procs = started
    deadline = time.time() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    errors, results = [], []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            errors.append(f"rank {r}: still running after {timeout_s} s")
            continue
        path = os.path.join(work, f"{part}_{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: exit code {p.exitcode}, no result")
            continue
        with open(path, "rb") as fh:  # written by this script's own ranks
            res = pickle.load(fh)
        if "error" in res:
            errors.append(f"rank {r}:\n{res['error']}")
        else:
            results.append(res["ok"])
    if errors:
        raise AssertionError(f"mesh part ({part}) failed:\n" + "\n".join(errors))
    return results


def mesh_phase(xgb_model, frame, X, smi, seed, n_rows, trees, drf_trees=5,
               air_rows=2_000_000, device="cuda:0"):
    """Row sharding over ``torch.distributed`` on the one card: (a) one
    rank with NCCL at world size 1, with ``entry.dryrun_multichip(1,
    device="cuda")`` and the one-device DRF that (b)'s is held to running
    beside it in this process (for the script's time), then (b) two gloo
    ranks sharing ``cuda:0`` (host-staged), each rank a spawned process.
    Returns the phase's record, with the kernel launches of the ranks' fits
    and of this process's DRF fit under ``launches``."""
    import tempfile

    import torch

    from h2o3_tpu_torch import DRF
    from h2o3_tpu_torch.entry import dryrun_multichip
    from h2o3_tpu_torch.ops import cuda_build

    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="mesh_phase_")
    rec = {"card": smi, "rows": n_rows, "parts_s": {}}
    one_trees = _trees_of(xgb_model.booster)
    one_margin = xgb_model.booster.predict_margin(X)
    one_auc = xgb_model.training_metrics.auc

    # (a) and, beside it in its own spawned rank, the dry run
    t0 = time.time()
    backend_a = "nccl" if torch.device(device).type == "cuda" else "gloo"
    started = start_mesh_part("a", 1, backend_a, device, work, (seed, n_rows, trees))
    dryrun_multichip(1, device=torch.device(device).type)
    rec["parts_s"]["dryrun_multichip_1"] = time.time() - t0
    before = dict(cuda_build.LAUNCHES)
    one_drf = DRF(response_column="y", ntrees=drf_trees, seed=seed).train(frame)
    torch.cuda.synchronize()
    one_drf_launches = {k: cuda_build.LAUNCHES[k] - before[k] for k in cuda_build.KERNELS}
    one_drf_trees = _trees_of(one_drf.booster)
    one_drf_auc = one_drf.training_metrics.auc
    rec["parts_s"]["one_device_drf"] = time.time() - t0
    a = join_mesh_part(started, work)[0]
    rec["parts_s"]["nccl_world_1"] = time.time() - t0
    want = {"hist_nodematmul": 6 * trees, "hist_sorted": 0, "hist_factorized": 0}
    if a["xgboost"]["launches"] != want:
        raise AssertionError(f"mesh (a): launches {a['xgboost']['launches']}, expected {want}")
    if not _trees_bits_equal(a["trees"], one_trees):
        raise AssertionError("mesh (a): trees at world size 1 differ from the one-device fit")
    if a["margin"].tobytes() != one_margin.tobytes():
        raise AssertionError("mesh (a): predictions differ from the one-device fit's bits")
    rec["nccl_world_1"] = {**a["xgboost"], "rank_s": a["rank_s"],
                           "trees_bits_equal": True, "predictions_bits_equal": True}

    t0 = time.time()
    b = join_mesh_part(start_mesh_part("b", 2, "gloo", device, work,
                                       (seed, n_rows, trees, drf_trees, air_rows)), work)
    rec["parts_s"]["gloo_world_2"] = time.time() - t0
    b0 = b[0]
    for r, o in enumerate(b):
        if o["xgboost"]["launches"] != want:
            raise AssertionError(f"mesh (b) rank {r}: XGBoost launches "
                                 f"{o['xgboost']['launches']}, expected {want}")
        dwant = {"hist_nodematmul": 8 * drf_trees, "hist_sorted": 4 * drf_trees,
                 "hist_factorized": 0}
        if o["drf"]["launches"] != dwant:
            raise AssertionError(f"mesh (b) rank {r}: DRF launches "
                                 f"{o['drf']['launches']}, expected {dwant}")
        for key in ("margin_sha1", "drf_margin_sha1"):
            if o[key] != b0[key]:
                raise AssertionError(f"mesh (b): rank {r}'s {key} differs from rank 0's")
        if not (_trees_bits_equal(o["trees"], b0["trees"])
                and _trees_bits_equal(o["drf_trees"], b0["drf_trees"])):
            raise AssertionError(f"mesh (b): rank {r}'s trees differ from rank 0's")
        for key in ("sort", "group_by", "gram"):
            if o[key]["sha1"] != b0[key]["sha1"]:
                raise AssertionError(f"mesh (b): rank {r}'s {key} differs from rank 0's")
    if not (b0["root"]["counts_equal"] and b0["root"]["close"]):
        raise AssertionError(f"mesh (b): merged root histogram {b0['root']}")
    level = b0["level"]
    if not (level["counts_equal"] and level["close"]
            and level["launches"]["hist_sorted"] == 2):
        raise AssertionError(f"mesh (b): merged B2 level histogram {level}")
    # each fit held to its one-device twin by the C3 rule: the same trees,
    # or else the AUC within 1e-4
    same, drf_same = (_trees_bits_equal(b0["trees"], one_trees),
                      _trees_bits_equal(b0["drf_trees"], one_drf_trees))
    auc, drf_auc = b0["xgboost"]["auc"], b0["drf"]["auc"]
    if not same and abs(auc - one_auc) > 1e-4:
        raise AssertionError(f"mesh (b): trees differ and AUC {auc} vs {one_auc}")
    if not drf_same and not abs(drf_auc - one_drf_auc) <= 1e-4:
        raise AssertionError(f"mesh (b): DRF trees differ and AUC {drf_auc} vs "
                             f"{one_drf_auc}")
    if not (b0["sort"]["equal"] and b0["group_by"]["counts_equal"] and b0["gram"]["ok"]):
        raise AssertionError(f"mesh (b): sort {b0['sort']}, group-by {b0['group_by']}, "
                             f"gram {b0['gram']}")
    rec["gloo_world_2"] = {
        "xgboost": b0["xgboost"], "trees_equal_one_device": same,
        "auc_one_device": one_auc,
        "max_abs_margin_diff": float(np.abs(b0["margin"] - one_margin).max()),
        "root": b0["root"], "level": level, "drf": b0["drf"],
        "drf_trees_equal_one_device": drf_same,
        "drf_splits_equal_one_device": _splits_equal(b0["drf_trees"], one_drf_trees),
        "drf_auc_one_device": one_drf_auc,
        "drf_one_device_launches": one_drf_launches, "sort": b0["sort"],
        "group_by": b0["group_by"], "gram": b0["gram"], "merge_ms": b0["merge_ms"],
        "peak_bytes": [o["peak_bytes"] for o in b], "parts_s": b0["parts"],
        "rank_s": [o["rank_s"] for o in b]}
    launches = {k: a["xgboost"]["launches"][k] + one_drf_launches[k] + sum(
        o["xgboost"]["launches"][k] + o["drf"]["launches"][k] for o in b)
        for k in cuda_build.KERNELS}
    rec["launches"] = launches
    rec["phase_s"] = time.time() - t_phase
    return rec


def kernel_record(name, source, replaces, checks, main_case, bf16_case, launches):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks if c["kernel"] == name),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        # the bf16 operand mode at one level the bf16 fits build
        "bf16": {key: bf16_case[key] for key in (
            "case", "max_abs_err", "ms", "f32_ms", "ms_again", "plain_ms",
            "library_ms", "bound_ms", "bound_by")},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--trees", type=int, default=10,
                    help="trees of the monotone XGBoost fit (twice as many "
                         "after its continuation)")
    ap.add_argument("--base-trees", type=int, default=4,
                    help="trees of the unconstrained XGBoost and GBM fits")
    ap.add_argument("--drf-trees", type=int, default=10,
                    help="trees of the DRF fit (DRF's own default: 50)")
    ap.add_argument("--wide-rows", type=int, default=300_000,
                    help="rows of the XGBoost fit at 512 bins and depth 8")
    ap.add_argument("--wide-trees", type=int, default=4,
                    help="trees of the XGBoost fit at 512 bins and depth 8")
    ap.add_argument("--bf16-trees", type=int, default=4,
                    help="trees of the bf16 XGBoost and monotone XGBoost fits")
    ap.add_argument("--bf16-drf-trees", type=int, default=5,
                    help="trees of the bf16 DRF fit")
    ap.add_argument("--cv-trees", type=int, default=4,
                    help="trees of each fit of the 3-fold XGBoost cross-validation")
    ap.add_argument("--mnist-rows", type=int, default=60_000,
                    help="rows of the MNIST-shaped frame of the GLM and "
                         "DeepLearning phases")
    ap.add_argument("--dl-epochs", type=int, default=2,
                    help="epochs of the main DeepLearning fit (one more "
                         "for its continuation)")
    ap.add_argument("--air-rows", type=int, default=50_000,
                    help="rows of the airlines-shaped frame of the AutoML phase "
                         "(cut from 100,000 for the phase's time, PERF.md section 4)")
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    ap.add_argument("--parent", default=None, metavar="CHECKOUT",
                    help="another checkout of the repository (e.g. the parent "
                         "commit's): check and time its factorized kernel in "
                         "turn with this one at each of its levels")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more XGBoost, DRF and monotone "
                         "XGBoost fit (device time by kernel)")
    args = ap.parse_args()
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from h2o3_tpu_torch import DRF, GBM, XGBoost
    from h2o3_tpu_torch.ops import cuda_build

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    t0 = time.time()
    cuda_build.build()
    build_s = time.time() - t0
    print(f"kernel build ({len(cuda_build.KERNELS)}, in parallel): {build_s:.1f} s",
          flush=True)
    parent = parent_factorized(args.parent) if args.parent else None
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    n, seed = args.rows, args.seed
    cases = [
        ("hist_nodematmul", n, 28, 257, 16, False),  # XGBoost's widest level built
        ("hist_nodematmul", n, 28, 257, 1, True),  # the root
        ("hist_nodematmul", n, 28, 257, 64, False),  # the widest level it serves
        ("hist_nodematmul", n, 28, 21, 8, False),  # GBM's widest level built
        ("hist_nodematmul", n, 28, 21, 64, True),  # DRF's level 7 (subtraction)
        ("hist_nodematmul", n, 11, 257, 40, True),  # F not a multiple of 8
        ("hist_sorted", n, 28, 21, 1024, False),  # DRF's widest level built
        ("hist_sorted", n, 28, 21, 128, False),  # DRF's level 8 (subtraction)
        ("hist_sorted", n, 28, 21, 2048, True),  # level 11 without subtraction
        ("hist_sorted", n, 28, 257, 512, False),  # XGBoost's 256 bins, 512 nodes
        ("hist_sorted", n, 11, 21, 300, True),  # K not a power of 2, F not of 8
        ("hist_factorized", n, 28, 257, 8, False),  # its widest level built
        ("hist_factorized", n, 28, 257, 1, True),  # the root
        ("hist_factorized", n, 28, 257, 16, False),
        ("hist_factorized", n, 28, 21, 8, False),
        ("hist_factorized", n, 11, 257, 5, True),  # K not a power of 2, F not of 8
    ]
    checks = [kernel_case(*c, seed=seed + i, dev=dev, parent=parent)
              for i, c in enumerate(cases)]
    cross = [cross_check("hist_sorted", n, 28, 21, 64, seed + len(cases), dev),
             cross_check("hist_factorized", n, 28, 257, 8, seed + len(cases) + 1, dev)]
    # levels whose per-warp [K, 3, B1] histogram did not fit shared memory
    # before the node-matmul kernel tiled each level's cells across warps
    wide_cases = [
        ("hist_nodematmul", n, 28, 303, 64, False),
        ("hist_nodematmul", n, 28, 1209, 16, True),  # depth 6 at 1,208 bins
        ("hist_nodematmul", n, 28, 513, 64, False),  # the 512-bin fit below
    ]
    checks += [kernel_case(*c, seed=seed + len(cases) + 2 + i, dev=dev)
               for i, c in enumerate(wide_cases)]
    # B1 tiles these levels' cells across warps (6 tiles at 16 nodes, 8 at
    # 64); each cell still adds its rows in B3's order: the same bits
    for i, k in enumerate((16, 64)):
        rec = cross_check("hist_factorized", n, 28, 257, k,
                          seed + len(cases) + 2 + len(wide_cases) + i, dev)
        if not rec["bit_identical"]:
            raise AssertionError(f"{rec['case']}: B1's tiled level is not B3's bits")
        cross.append(rec)
    # the bf16 operand mode at one level of each kernel that the bf16 fits
    # build (B1's tile and warp kernels, B2, B3), on the f32 cases' inputs
    bf16_cases = [(cases.index(c), c) for c in (
        ("hist_nodematmul", n, 28, 257, 16, False),  # hist_tile_kernel
        ("hist_nodematmul", n, 28, 21, 8, False),  # hist_warp_kernel
        ("hist_sorted", n, 28, 21, 1024, False),
        ("hist_factorized", n, 28, 257, 8, False))]
    bf16_checks = [kernel_case(*c, seed=seed + i, dev=dev, dtype="bf16", parent=parent)
                   for i, c in bf16_cases]
    checks += bf16_checks
    # the factorized kernel's other levels in the monotone fit (2 and 4
    # nodes), and its widest at 60% inactive rows, the share a level past
    # the root has under subtraction
    more_b3 = [("hist_factorized", n, 28, 257, 2, False),
               ("hist_factorized", n, 28, 257, 4, False),
               ("hist_factorized", n, 28, 257, 8, False)]
    checks += [kernel_case(*c, seed=seed + 200 + i, dev=dev, parent=parent,
                           inactive=0.6 if i == 2 else 0.3)
               for i, c in enumerate(more_b3)]
    # B3 in bf16 gives the bits of B1 in bf16
    rec = cross_check("hist_factorized", n, 28, 257, 8, seed + len(cases) + 1, dev,
                      dtype="bf16")
    if not rec["bit_identical"]:
        raise AssertionError(f"{rec['case']}: B3 in bf16 is not B1's bits in bf16")
    cross.append(rec)
    torch.cuda.empty_cache()
    rand = jrandom_check(dev)

    X, y, logit = synth_higgs(n, 28, seed)
    binning = binning_phase(X, seed, dev)
    keys = CacheKeys()
    frame = keys.name(make_frame(X, y), "higgs")
    small_frame = keys.name(make_frame(*synth_higgs(20_000, 28, seed + 1)[:2]), "small")
    wide_n = min(args.wide_rows, n)
    wide_frame = keys.name(make_frame(X[:wide_n], y[:wide_n]), "wide")

    def expect(nodematmul=0, sorted_=0, factorized=0):
        return {"hist_nodematmul": nodematmul, "hist_sorted": sorted_,
                "hist_factorized": factorized}

    xgb_rec, xgb_model = run_fit(XGBoost, frame, n, expect(args.base_trees * 6),
                                 "xgboost", small_frame, keys,
                                 ntrees=args.base_trees, seed=seed)
    fits = [
        xgb_rec,
        run_fit(GBM, frame, n, expect(args.base_trees * 5), "gbm", small_frame,
                keys, ntrees=args.base_trees, seed=seed)[0],
    ]
    # DRF at depth 12 with subtraction: levels 0-7 build <= 64 nodes
    # (node-matmul), levels 8-11 build 128-1024 (sorted); 12 is terminal.
    # With GBM's 20 bins and seed it hits GBM's entry, and its first sorted
    # level makes the row-major codes there, once: the entry grows by them
    gbm_entry = frame_entry(frame, 20)
    entry_bytes = [gbm_entry.nbytes]
    drf_rec, drf_model = run_fit(DRF, frame, n,
                                 expect(args.drf_trees * 8, args.drf_trees * 4),
                                 "drf", small_frame, keys, ntrees=args.drf_trees,
                                 seed=seed)
    fits.append(drf_rec)
    codes_rm = gbm_entry.value.arrays["codes_rm"]
    entry_bytes.append(gbm_entry.nbytes)
    if codes_rm is None or entry_bytes[1] - entry_bytes[0] != codes_rm.nbytes:
        raise AssertionError(
            f"drf: GBM's entry grew {entry_bytes}, not by its row-major codes "
            f"({None if codes_rm is None else codes_rm.nbytes} bytes)")
    fits[-1]["entry_bytes"] = entry_bytes
    # the monotone XGBoost path: levels padded to 8 nodes (K·4 <= 32) on the
    # factorized kernel, the 16-node level on the node-matmul kernel
    monotone = {f"x{j}": int(np.sign(np.corrcoef(X[:, j], y)[0, 1])) for j in (2, 3)}
    mono_rec, mono_model = run_fit(
        XGBoost, frame, n, expect(args.trees, 0, args.trees * 5), "xgboost_monotone",
        small_frame, keys, ntrees=args.trees, seed=seed, monotone_constraints=monotone,
        hist_fact_max_kc=32)
    mono_rec["monotone_constraints"] = monotone
    fits.append(mono_rec)
    fits.append(continue_fit(
        XGBoost, frame, X, mono_model, 2 * args.trees,
        expect(args.trees, 0, args.trees * 5), "xgboost_monotone_continued",
        monotone, keys, seed=seed, hist_fact_max_kc=32))
    # 512 bins at depth 8: built levels of 1, 1, 2, ..., 64 nodes at 513
    # bins, each on the node-matmul kernel. Held to the plain histogram on
    # the card only: a 20,000-row fit this deep parts from the CPU's at near
    # ties with the plain histogram on the card too (the card and the CPU
    # round their float sums differently), so that comparison would not test
    # the kernel; the CPU tests hold this configuration to the JAX package.
    fits.append(run_fit(
        XGBoost, wide_frame, wide_n,
        expect(args.wide_trees * 8), "xgboost_512_bins_depth_8", None, keys,
        ntrees=args.wide_trees, seed=seed, nbins=512, max_depth=8)[0])
    # the bf16 operand mode, the JAX package's default on its own chip,
    # through all three kernels; each held to its plain-histogram twin in
    # bf16 on the card, its AUC beside its f32 twin's
    bt, bd = args.bf16_trees, args.bf16_drf_trees
    for builder, launches, label, kw in (
            (XGBoost, expect(bt * 6), "xgboost_bf16", dict(ntrees=bt)),
            (DRF, expect(bd * 8, bd * 4), "drf_bf16", dict(ntrees=bd)),
            (XGBoost, expect(bt, 0, bt * 5), "xgboost_monotone_bf16",
             dict(ntrees=bt, monotone_constraints=monotone, hist_fact_max_kc=32))):
        rec, model = run_fit(builder, frame, n, launches, label, None, keys, seed=seed,
                             hist_dtype="bf16", **kw)
        rec["f32_auc"] = f32_auc(keys, f"{label} f32", builder, frame, seed=seed, **kw)
        if "monotone_constraints" in kw:
            rec["monotone_sweeps"] = monotone_sweeps(label, model, X, monotone)
        print(f"bf16 fit: {label} AUC {rec['auc']} (f32 {rec['f32_auc']})", flush=True)
        fits.append(rec)
    # the bf16 DRF fit hit GBM's entry and made no second row-major copy
    if gbm_entry.nbytes != entry_bytes[1] or gbm_entry.value.arrays["codes_rm"] is not codes_rm:
        raise AssertionError("drf_bf16: GBM's entry changed after its first DRF fit")
    cv = cv_phase(keys, XGBoost, wide_frame, wide_n, seed, args.cv_trees)
    cache_stats = check_no_evictions()
    t0 = time.time()
    surface = surface_phase(xgb_model, drf_model, frame, n, dev,
                            sub_rows=min(300_000, n))
    surface["phase_s"] = time.time() - t0
    print(json.dumps({"surface": surface}), flush=True)

    # the dense-design models: no histogram kernel runs in them
    launches_before = dict(cuda_build.LAUNCHES)
    mnist = synth_mnist(args.mnist_rows, seed + 11)
    t0 = time.time()
    glm_rec = glm_phase(frame, X, y, logit.astype(np.float32), mnist,
                        synth_prostate(380, seed + 12), dev, seed,
                        sub_rows=min(200_000, n), mnist_rows=args.mnist_rows)
    glm_rec["phase_s"] = time.time() - t0
    print(json.dumps({"glm": glm_rec}), flush=True)
    t0 = time.time()
    dl_rec = deeplearning_phase(mnist, frame, dev, seed, epochs=args.dl_epochs,
                                ae_rows=min(100_000, n))
    dl_rec["phase_s"] = time.time() - t0
    print(json.dumps({"deeplearning": dl_rec}), flush=True)
    if cuda_build.LAUNCHES != launches_before:
        raise AssertionError(f"a histogram kernel ran in the GLM or DeepLearning phase: "
                             f"{cuda_build.LAUNCHES} (before: {launches_before})")
    t0 = time.time()
    automl_rec = automl_phase(synth_airlines(args.air_rows, seed + 13), dev, seed,
                              sub_rows=min(10_000, args.air_rows))
    automl_rec["phase_s"] = time.time() - t0
    print(json.dumps({"automl": automl_rec}), flush=True)
    # the cluster, decomposition, NaiveBayes and isolation-forest models:
    # no histogram kernel runs in them
    launches_before = dict(cuda_build.LAUNCHES)
    t0 = time.time()
    breadth_rec = breadth_phase(frame, clustered_frame(X, seed + 15), mnist,
                                synth_airlines(1_000_000, seed + 14), dev, seed,
                                sub_rows=min(200_000, n))
    breadth_rec["phase_s"] = time.time() - t0
    print(json.dumps({"breadth": breadth_rec}), flush=True)
    if cuda_build.LAUNCHES != launches_before:
        raise AssertionError(f"a histogram kernel ran in the breadth phase: "
                             f"{cuda_build.LAUNCHES} (before: {launches_before})")

    # GAM, CoxPH, PSVM and Word2Vec: no histogram kernel runs in them
    launches_before = dict(cuda_build.LAUNCHES)
    t0 = time.time()
    # the corpus is cut from 1,000,000 tokens for the phase's time (PERF.md section 4)
    breadth2_rec = breadth2_phase(frame, logit, synth_survival(1_000_000, 28, seed + 17),
                                  synth_corpus(400_000, 50_000, seed + 18), dev, seed,
                                  sub_rows=min(200_000, n))
    breadth2_rec["phase_s"] = time.time() - t0
    breadth2_rec["card"] = smi
    print(json.dumps({"breadth2": breadth2_rec}), flush=True)
    if cuda_build.LAUNCHES != launches_before:
        raise AssertionError(f"a histogram kernel ran in the breadth2 phase: "
                             f"{cuda_build.LAUNCHES} (before: {launches_before})")

    # Aggregator, RuleFit, segment models, Generic, Assembly and the
    # pipeline, the reference-format MOJO: B1 in RuleFit's and the
    # segments' fits and the pipeline's GBM, counted there
    t0 = time.time()
    breadth3_rec = breadth3_phase(frame, synth_airlines(1_000_000, seed + 14), dev, seed,
                                  rf_rows=min(100_000, n))
    breadth3_rec["phase_s"] = time.time() - t0
    breadth3_rec["card"] = smi
    print(json.dumps({"breadth3": breadth3_rec}), flush=True)

    # the Rapids engine: fused column programs, the device sort, merge and
    # group-by, quantiles, the matrix product and rollups against their
    # plain versions; no histogram kernel runs in it
    launches_before = dict(cuda_build.LAUNCHES)
    t0 = time.time()
    air2m = synth_airlines(2_000_000, seed + 20)
    rapids_rec = rapids_phase(frame, air2m, dev, seed)
    rapids_rec["phase_s"] = time.time() - t0
    rapids_rec["card"] = smi
    print(json.dumps({"rapids": rapids_rec}), flush=True)
    if cuda_build.LAUNCHES != launches_before:
        raise AssertionError(f"a histogram kernel ran in the Rapids phase: "
                             f"{cuda_build.LAUNCHES} (before: {launches_before})")

    # the host prims of search, advmath, strings, times and models, fed by
    # regions fused on the card; no histogram kernel runs in it but the
    # B1 of its own segment fit, made only when no earlier one is left
    launches_before = dict(cuda_build.LAUNCHES)
    t0 = time.time()
    prims_rec = rapids_prims_phase(frame, air2m, xgb_model, dev, seed)
    prims_rec["phase_s"] = time.time() - t0
    prims_rec["card"] = smi
    print(json.dumps({"rapids_prims": prims_rec}), flush=True)
    ran = {k: cuda_build.LAUNCHES[k] - launches_before[k] for k in cuda_build.KERNELS}
    if ran != prims_rec["launches"]:
        raise AssertionError(f"the Rapids prims phase launched {ran}, its segment fit "
                             f"{prims_rec['launches']}")

    # row sharding over torch.distributed: spawned ranks on this card; the
    # launches of their fits come back in the record; this process launches
    # only those of the one-device DRF that the ranks' DRF is held to
    mesh_rec = mesh_phase(xgb_model, frame, X, smi, seed, n, args.base_trees)
    print(json.dumps({"mesh": mesh_rec}), flush=True)
    one_drf = mesh_rec["gloo_world_2"]["drf_one_device_launches"]
    if one_drf != expect(5 * 8, 5 * 4):
        raise AssertionError(f"the mesh phase's one-device DRF launched {one_drf}")

    prof = ([profile_fit(XGBoost, frame, "xgboost", ntrees=args.base_trees, seed=seed),
             profile_fit(DRF, frame, "drf", ntrees=args.drf_trees, seed=seed),
             profile_fit(XGBoost, frame, "xgboost_monotone", ntrees=args.trees,
                         seed=seed, monotone_constraints=monotone,
                         hist_fact_max_kc=32)]
            if args.profile else None)

    total = {k: sum(f["launches"][k] for f in fits + [cv, automl_rec, breadth3_rec, prims_rec,
                                                       mesh_rec])
             for k in cuda_build.KERNELS}
    kernels = [
        kernel_record("hist_nodematmul", "h2o3_tpu_torch/csrc/hist_nodematmul.cu",
                      "h2o3_tpu/ops/pallas_histogram.py:94", checks, checks[0],
                      bf16_checks[0], total["hist_nodematmul"]),
        kernel_record("hist_sorted", "h2o3_tpu_torch/csrc/hist_sorted.cu",
                      "h2o3_tpu/ops/pallas_histogram.py:353", checks, checks[6],
                      bf16_checks[2], total["hist_sorted"]),
        kernel_record("hist_factorized", "h2o3_tpu_torch/csrc/hist_factorized.cu",
                      "h2o3_tpu/ops/pallas_histogram.py:243", checks, checks[11],
                      bf16_checks[3], total["hist_factorized"]),
    ]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "device": kind, "torch": torch.__version__,
                       "build_s": build_s, "kernel_checks": checks,
                       "cross_check": cross, "jrandom": rand, "binning": binning,
                       "fits": fits, "cv": cv, "devcache": cache_stats,
                       "surface": surface, "glm": glm_rec, "deeplearning": dl_rec,
                       "automl": automl_rec, "breadth": breadth_rec,
                       "breadth2": breadth2_rec, "breadth3": breadth3_rec,
                       "rapids": rapids_rec, "rapids_prims": prims_rec,
                       "mesh": mesh_rec, "profile": prof, "kernels": kernels}, fh,
                      indent=1)
    print(f"chip_smoke: whole run {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
