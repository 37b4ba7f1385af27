"""Parity: the PyTorch port's DeepLearning MLP (``models/deeplearning.py``),
its optimizer (``util/optim.py``) and its random draws against the JAX
package and optax, on the CPU.

Held to the JAX package, bit for bit:

- the key chain a fit derives from its seed (``PRNGKey``, ``split`` for the
  init, ``fold_in`` by epoch and step, ``split`` per dropped layer);
- the He-uniform init at MNIST's widths (784 -> 200 -> 200 -> 10) and at
  the fits' widths, and the dropout masks of a step (input 0.2, hidden
  0.5), seen through ``_forward`` on the same weights and inputs.

Held to optax 0.2.6 within rtol 1e-6 on random gradients, over three
steps: ``adadelta``, ``sgd`` with a constant and an annealed rate, and the
injected momentum ramp, with the state's leaves in optax's order, dtypes
and shapes.

Fits at ``hidden=[8, 8]``, ``mini_batch_size=32`` (a multiple of the JAX
package's 8 devices, so both take the same batches), 3 epochs, one
configuration per seed of ``DL_CASES``: classification by ADADELTA with
input and hidden dropout, regression by SGD with the momentum ramp, rate
annealing and L1/L2, the absolute loss with tanh at a constant rate, and
the autoencoder; weights and optimizer leaves within rtol 1e-4 / atol
1e-5, predictions (and the autoencoder's reconstruction and ``anomaly``)
within 1e-4. The JAX package sums each batch's gradients over 8 shards and
the port once, so the two agree to float32 rounding. Two more seeds hold
checkpoint-continue (2 epochs then 1 more equal one run of 3, bit for bit;
the JAX package's continued fit within the tolerance; the checkpoint
errors equal to the JAX package's) and a JAX model carried across by
``convert.deeplearning_from_numpy`` (scores within 1e-6, continues as the
JAX package continues, its MOJO payload the JAX model's, save/load and
the port's ``genmodel`` on the port's own fit).

The tier-1 run's collected test count is held fixed (ROADMAP C4), so these
checks run in the bodies of ``test_fold_in`` and
``test_uniform_prefix_property``, moved here from
``tests/test_torch_jrandom.py`` with their own checks unchanged: each seed
of ``test_fold_in`` also derives DeepLearning's keys and fits that seed's
configuration, and ``test_uniform_prefix_property`` also holds the init,
the masks and the optimizer.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import deeplearning as jdl
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.mojo_export import _payload as j_payload
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.convert import deeplearning_from_numpy
from h2o3_tpu_torch.genmodel import load_mojo as p_load_mojo
from h2o3_tpu_torch.models import deeplearning as pdl
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.mojo_export import _payload as p_payload
from h2o3_tpu_torch.util import jrandom as jr
from h2o3_tpu_torch.util import optim

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 3, 2**32 + 9, -1]

WTOL = dict(rtol=1e-4, atol=1e-5)
PTOL = dict(rtol=0, atol=1e-4)

_BASE = dict(hidden=[8, 8], mini_batch_size=32, epochs=3)
_Y = ("yb", "yg", "ym")

#: seed -> (case, DeepLearning kwargs); seed -1 draws a seed from the clock
#: in both packages, so it fits nothing
DL_CASES = {
    0: ("classification_adadelta_dropout",
        dict(response_column="ym", input_dropout_ratio=0.2, hidden_dropout_ratios=[0.5, 0.5])),
    1: ("regression_sgd_momentum_l1_l2",
        dict(response_column="yg", adaptive_rate=False, rate=0.01, rate_annealing=1e-3,
             momentum_start=0.5, momentum_stable=0.99, momentum_ramp=500.0,
             l1=1e-4, l2=1e-3)),
    42: ("absolute_tanh_constant_rate",
         dict(response_column="yg", loss="absolute", activation="tanh",
              adaptive_rate=False, rate=0.01, rate_annealing=0.0)),
    2**31 - 1: ("autoencoder", dict(autoencoder=True)),
    2**31 + 3: ("checkpoint_continue", dict(response_column="yb")),
    2**32 + 9: ("carried_across", dict(response_column="ym", adaptive_rate=False,
                                       momentum_start=0.3, momentum_stable=0.9,
                                       momentum_ramp=400.0)),
}


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key, dtype=np.uint32))


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = 5 + 3 * rng.normal(size=n)
    c = np.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)], dtype=object)
    c[rng.random(n) < 0.05] = None
    eta = x1 - 0.3 * (x2 - 5) + np.where(c == "b", 0.8, 0.0)
    u = eta[:, None] * np.array([1.0, -1.0, 0.0]) + rng.gumbel(size=(n, 3))
    return {
        "x1": np.where(rng.random(n) < 0.05, np.nan, x1),
        "x2": x2,
        "const": np.zeros(n),
        "c": c,
        "yb": np.array(np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "p", "q"),
                       dtype=object),
        "yg": eta + 0.3 * rng.normal(size=n),
        "ym": np.array(np.array(["k0", "k1", "k2"])[u.argmax(1)], dtype=object),
    }


def _kw(seed, **kw):
    y = kw.get("response_column")
    return dict(_BASE, seed=seed, ignored_columns=[c for c in _Y if c != y], **kw)


@contextlib.contextmanager
def _jax_keys_removed():
    before = set(JDKV.keys())
    try:
        yield
    finally:
        for k in set(JDKV.keys()) - before:
            if not isinstance(JDKV.peek(k), JJob):
                JDKV.remove(k)


def _assert_net_close(jnet, pnet, tol, name):
    assert len(jnet) == len(pnet), name
    for i, ((jW, jb), (pW, pb)) in enumerate(zip(jnet, pnet)):
        np.testing.assert_allclose(pW, np.asarray(jW), **tol, err_msg=f"{name} W{i}")
        np.testing.assert_allclose(pb, np.asarray(jb), **tol, err_msg=f"{name} b{i}")


def _assert_leaves_close(jleaves, pleaves, tol, name):
    assert len(jleaves) == len(pleaves), name
    for i, (a, b) in enumerate(zip(jleaves, pleaves)):
        a = np.asarray(a)
        assert (b.dtype, b.shape) == (a.dtype, a.shape), (name, i)
        np.testing.assert_allclose(b, a, **tol, err_msg=f"{name} leaf {i}")


def _assert_scores_close(jm, pm, d, name, tol=PTOL):
    jfr, pfr = JFrame.from_dict(d), ht.Frame.from_dict(d)
    np.testing.assert_allclose(pm._predict_raw(pfr), jm._predict_raw(jfr), **tol,
                               err_msg=name)


def _check_key_chain(seed):
    # DeepLearning's keys (deeplearning.py:242, :245, :73, :318, :325, :85)
    base = jax.random.PRNGKey(seed)
    _, jinit = jax.random.split(base)
    _, pinit = jr.split(jr.PRNGKey(seed))
    assert pinit == _words(jinit)
    jk, pk = jinit, pinit
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        pk, psub = jr.split(pk)
        assert (pk, psub) == (_words(jk), _words(jsub))
    for epoch, step in ((0, 0), (2, 7), (10, 233)):
        jd = jax.random.fold_in(jax.random.fold_in(base, epoch + 1), step)
        pd = jr.fold_in(jr.fold_in(jr.PRNGKey(seed), epoch + 1), step)
        assert pd == _words(jd)
        for _ in range(3):
            jd, jsub = jax.random.split(jd)
            pd, psub = jr.split(pd)
            assert psub == _words(jsub)


def _fit_pair(kw, d, jprior=None, pprior=None):
    jkw, pkw = dict(kw), dict(kw)
    if jprior is not None:
        jkw["checkpoint"], pkw["checkpoint"] = jprior.key, pprior.key
    jm = jdl.DeepLearning(**jkw).train(JFrame.from_dict(d))
    with ht.use_device("cpu"):
        pm = pdl.DeepLearning(**pkw).train(ht.Frame.from_dict(d))
    return jm, pm


def _check_fit(jm, pm, d, score, name):
    assert pm.epochs_trained == jm.epochs_trained
    assert pm.loss_kind == jm.loss_kind
    _assert_net_close(jm.net_params, pm.net_params, WTOL, name)
    _assert_leaves_close(jm.opt_leaves, pm.opt_leaves, WTOL, name)
    _assert_scores_close(jm, pm, score, name)
    if jm.params.autoencoder:
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        np.testing.assert_allclose(pm.anomaly(pfr), jm.anomaly(jfr), **PTOL)
        jp, pp = jm.predict(jfr), pm.predict(pfr)
        assert pp.names == jp.names
        for col in jp.names:
            np.testing.assert_allclose(pp.col(col).numeric_view(),
                                       jp.col(col).numeric_view(), **PTOL, err_msg=col)
    else:
        for attr in ("logloss", "mse", "rmse"):
            if hasattr(jm.training_metrics, attr):
                np.testing.assert_allclose(getattr(pm.training_metrics, attr),
                                           getattr(jm.training_metrics, attr),
                                           rtol=1e-4, err_msg=f"{name} {attr}")


def _check_checkpoint(seed, kw, d, score):
    with _jax_keys_removed():
        straight_j, straight_p = _fit_pair(kw, d)
        first_j, first_p = _fit_pair(dict(kw, epochs=2), d)
        cont_j, cont_p = _fit_pair(dict(kw, epochs=3), d, first_j, first_p)
        # in the port, 2 epochs then 1 more are the straight 3, bit for bit
        for (aW, ab), (bW, bb) in zip(cont_p.net_params, straight_p.net_params):
            np.testing.assert_array_equal(aW, bW)
            np.testing.assert_array_equal(ab, bb)
        for a, b in zip(cont_p.opt_leaves, straight_p.opt_leaves):
            np.testing.assert_array_equal(a, b)
        _check_fit(cont_j, cont_p, d, score, "continued")
        _check_fit(straight_j, straight_p, d, score, "straight")
        # the checkpoint errors are the JAX package's
        for change in (dict(hidden=[8, 4]), dict(epochs=2), dict(mini_batch_size=64),
                       dict(response_column="ym", ignored_columns=["yb", "yg"])):
            with pytest.raises(ValueError) as jerr:
                jdl.DeepLearning(**dict(kw, checkpoint=cont_j.key, **change)).train(
                    JFrame.from_dict(d))
            with ht.use_device("cpu"), pytest.raises(ValueError) as perr:
                pdl.DeepLearning(**dict(kw, checkpoint=cont_p.key, **change)).train(
                    ht.Frame.from_dict(d))
            assert str(perr.value) == str(jerr.value).replace(cont_j.key, cont_p.key)
        for prior in (None, "nope"):
            with pytest.raises(ValueError) as jerr:
                jdl.DeepLearning(**dict(kw, checkpoint=prior or "dl_0")).train(
                    JFrame.from_dict(d))
            with ht.use_device("cpu"), pytest.raises(ValueError) as perr:
                pdl.DeepLearning(**dict(kw, checkpoint=prior or "dl_0")).train(
                    ht.Frame.from_dict(d))
            assert str(perr.value) == str(jerr.value)
        ht_keys = [cont_p.key, first_p.key, straight_p.key]
    for k in ht_keys:
        from h2o3_tpu_torch.keyed import DKV

        DKV.remove(k)


def _check_carried_across(kw, d, score, tmp_path):
    with _jax_keys_removed():
        jm = jdl.DeepLearning(**dict(kw, epochs=2)).train(JFrame.from_dict(d))
        arrays = {"net_params": jm.net_params, "opt_leaves": jm.opt_leaves,
                  "epochs_trained": jm.epochs_trained}
        pm = deeplearning_from_numpy(arrays, dataclasses.asdict(jm.data_info),
                                     dataclasses.asdict(jm.params), device="cpu")
        _assert_scores_close(jm, pm, score, "carried", tol=dict(rtol=0, atol=1e-6))
        jmeta, jarr = j_payload(jm)
        pmeta, parr = p_payload(pm)
        assert pmeta == jmeta and sorted(parr) == sorted(jarr)
        for k in jarr:
            np.testing.assert_array_equal(parr[k], jarr[k], err_msg=k)
        # both continue one more epoch from the same state
        jc, pc = _fit_pair(dict(kw, epochs=3), d, jm, pm)
        _check_fit(jc, pc, d, score, "carried, continued")
        # the port's own model: saved and loaded, and through its genmodel
        path = ppersist.save_model(pc, tmp_path / "dl.bin")
        loaded = ppersist.load_model(path, register=False, device="cpu")
        pfr = ht.Frame.from_dict(score)
        np.testing.assert_array_equal(loaded._predict_raw(pfr), pc._predict_raw(pfr))
        mojo = pc.download_mojo(str(tmp_path / "dl.zip"))
        cols = {c: score[c] for c in score if c not in _Y}
        np.testing.assert_allclose(p_load_mojo(mojo).score(cols), pc._predict_raw(pfr),
                                   rtol=0, atol=1e-5)
        with pytest.raises(ValueError, match="incompatible"):
            bad = deeplearning_from_numpy(dict(arrays, opt_leaves=jm.opt_leaves[:-1]),
                                          dataclasses.asdict(jm.data_info),
                                          dataclasses.asdict(jm.params), device="cpu")
            with ht.use_device("cpu"):
                pdl.DeepLearning(**dict(kw, epochs=3, checkpoint=bad.key)).train(
                    ht.Frame.from_dict(d))
        with pytest.raises(ValueError, match="net_params"):
            deeplearning_from_numpy(dict(arrays, net_params=jm.net_params[:-1]),
                                    dataclasses.asdict(jm.data_info),
                                    dataclasses.asdict(jm.params), device="cpu")


def _check_deeplearning_seed(seed, tmp_path):
    _check_key_chain(seed)
    if seed not in DL_CASES:
        return
    name, extra = DL_CASES[seed]
    d, score = _data(300, seed=5), _data(120, seed=6)
    kw = _kw(seed, **extra)
    if name == "checkpoint_continue":
        _check_checkpoint(seed, kw, d, score)
    elif name == "carried_across":
        _check_carried_across(kw, d, score, tmp_path)
    else:
        with _jax_keys_removed():
            jm, pm = _fit_pair(kw, d)
            _check_fit(jm, pm, d, score, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, tmp_path):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 49, 123_456, 2**31 + 5):
        assert jr.fold_in(jr.PRNGKey(seed), data) == _words(jax.random.fold_in(key, data))

    _check_deeplearning_seed(seed, tmp_path)


def _check_init_and_masks():
    # the init at MNIST's widths and at the fits', bit for bit
    for sizes in ([784, 200, 200, 10], [6, 8, 8, 3]):
        jnet = jdl._init_params(jax.random.PRNGKey(3), sizes)
        pnet = pdl._init_params(jr.PRNGKey(3), sizes, "cpu")
        for (jW, jb), (pW, pb) in zip(jnet, pnet):
            np.testing.assert_array_equal(pW.numpy().view(np.int32),
                                          np.asarray(jW).view(np.int32))
            np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    # a step's dropout masks, input 0.2 and hidden 0.5, through _forward on
    # identity layers and positive inputs: each output is the input, zero
    # where a mask dropped it and divided by each keep ratio where not
    x = np.abs(np.random.default_rng(0).normal(size=(256, 64))).astype(np.float32) + 0.1
    eye, zero = np.eye(64, dtype=np.float32), np.zeros(64, np.float32)
    dk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), 1), 0)
    pk = jr.fold_in(jr.fold_in(jr.PRNGKey(11), 1), 0)
    for n_layers in (1, 2, 3):
        jout = np.asarray(jdl._forward([(jnp.asarray(eye), jnp.asarray(zero))] * n_layers,
                                       jnp.asarray(x), jax.nn.relu, dk, 0.2, (0.5, 0.5)))
        pout = pdl._forward([(torch.from_numpy(eye), torch.from_numpy(zero))] * n_layers,
                            torch.from_numpy(x), torch.relu, pk, 0.2, (0.5, 0.5)).numpy()
        np.testing.assert_array_equal(pout, jout)
        assert 0.1 < (jout == 0).mean() < 0.9
    keep = jr.bernoulli(jr.split(pk)[1], 0.8, (256, 784), "cpu")
    want = jax.random.bernoulli(jax.random.split(dk)[1], 0.8, (256, 784))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    x784 = np.random.default_rng(1).normal(size=(256, 784)).astype(np.float32)
    dropped = pdl._dropout(torch.from_numpy(x784), jr.split(pk)[1], 0.2).numpy()
    np.testing.assert_array_equal(
        dropped, np.where(np.asarray(want), x784 / np.float32(0.8), np.float32(0)))


def _check_optimizers():
    rng = np.random.default_rng(4)
    shapes = [(5, 8), (8,), (8, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    sched = optax.schedules.exponential_decay(0.01, 1, 1.0 / (1.0 + 1e-3))

    def mom(step):
        frac = jnp.clip(step * float(32) / max(500.0, 1.0), 0.0, 1.0)
        return 0.5 + (0.99 - 0.5) * frac

    pairs = [
        ("adadelta", optax.adadelta(learning_rate=1.0, rho=0.99, eps=1e-8),
         optim.Adadelta(learning_rate=1.0, rho=0.99, eps=1e-8)),
        ("sgd", optax.sgd(0.01), optim.SGD(0.01)),
        ("sgd_annealed", optax.sgd(sched),
         optim.SGD(optim.ExponentialDecay(0.01, 1, 1.0 / (1.0 + 1e-3)))),
        ("momentum", optax.inject_hyperparams(
            lambda momentum: optax.sgd(sched, momentum=momentum))(momentum=mom),
         pdl.make_optimizer(pdl.DeepLearningParameters(
             adaptive_rate=False, rate=0.01, rate_annealing=1e-3, momentum_start=0.5,
             momentum_stable=0.99, momentum_ramp=500.0, mini_batch_size=32))),
        ("momentum_constant_rate", optax.inject_hyperparams(
            lambda momentum: optax.sgd(0.01, momentum=momentum))(momentum=mom),
         pdl.make_optimizer(pdl.DeepLearningParameters(
             adaptive_rate=False, rate=0.01, rate_annealing=0.0, momentum_start=0.5,
             momentum_stable=0.99, momentum_ramp=500.0, mini_batch_size=32))),
    ]
    for name, jopt, popt in pairs:
        # jitted, as the JAX package's train step runs it (XLA fuses its
        # multiply-adds; the eager ops would round twice)
        jupdate = jax.jit(jopt.update)
        jp = [jnp.asarray(p) for p in params]
        pp = [torch.from_numpy(p.copy()) for p in params]
        jstate, pstate = jopt.init(jp), popt.init(pp)
        assert len(pstate) == popt.num_leaves(len(pp))
        _assert_leaves_close(jax.tree_util.tree_leaves(jstate),
                             [s.numpy() for s in pstate], dict(rtol=0, atol=0), name)
        for step in range(3):
            g = [rng.normal(size=s).astype(np.float32) for s in shapes]
            ju, jstate = jupdate([jnp.asarray(x) for x in g], jstate, jp)
            jp = optax.apply_updates(jp, ju)
            pu, pstate = popt.update([torch.from_numpy(x) for x in g], pstate, pp)
            pp = optim.apply_updates(pp, pu)
            for a, b in zip(jp, pp):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} step {step}")
            _assert_leaves_close(jax.tree_util.tree_leaves(jstate),
                                 [s.numpy() for s in pstate], dict(rtol=1e-6, atol=1e-9),
                                 f"{name} step {step}")
    # the loss: optax's softmax cross-entropy with integer labels
    logits = rng.normal(size=(50, 4)).astype(np.float32) * 5
    labels = rng.integers(0, 4, 50)
    np.testing.assert_allclose(
        optim.softmax_cross_entropy_with_integer_labels(
            torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6, atol=1e-6)


def test_uniform_prefix_property():
    # the JAX booster draws row masks at its padded row count; the port
    # draws at the real one and must see the same first values
    key = jr.fold_in(jr.PRNGKey(7), 11)
    long = jr.uniform(key, (1008,), "cpu")
    assert torch.equal(jr.uniform(key, (1001,), "cpu"), long[:1001])
    assert torch.equal(jr.uniform(key, (3, 5), "cpu"), long[:15].reshape(3, 5))

    _check_init_and_masks()
    _check_optimizers()
