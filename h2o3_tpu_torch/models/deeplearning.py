"""DeepLearning — the port of ``h2o3_tpu/models/deeplearning.py``.

A multilayer perceptron (``hex/deeplearning``: ``Neurons.java:184-229``
fprop/bprop) trained by synchronous mini-batch steps, ADADELTA (the
reference's ``adaptive_rate`` default) or SGD with rate annealing and a
momentum ramp, with input and hidden dropout, L1/L2 and the autoencoder
mode. Forward and backward run on the device: one ``[B, in] x [in, out]``
matmul per layer, gradients from ``torch.autograd``, the optax updates of
``util/optim.py``.

What must match the JAX package, and does:

- the weight init: He-uniform ``U(-b, b)``, ``b = sqrt(6 / (fan_in +
  fan_out))`` in float32, drawn through ``util/jrandom.py`` from the same
  threefry keys (``split`` of ``PRNGKey(seed)``, then one ``split`` per
  layer), bit for bit;
- the dropout masks: ``fold_in(fold_in(key, epoch + 1), step)``, one
  ``split`` per dropped layer, ``bernoulli(1 - ratio)``, bit for bit;
- the batches: the batch size rounded down to the device count (one card
  here: the batch size itself; the JAX package rounds to its mesh), the
  per-epoch permutation of ``np.random.default_rng(seed + 1_000_003 *
  (epoch + 1))``, and a short last batch cycled from the permutation;
- the optimizer state: optax's leaves in optax's order (``opt_leaves``),
  so a checkpoint continues exactly, k epochs then k more giving one run
  of 2k epochs.

The training matrix and response are placed on the device once per (frame
state, design parameters, device) through ``frame/devcache.cached`` (kind
``deeplearning_train``), and each step gathers its batch there with
``index_select`` on the epoch's permutation, which is placed once per
epoch. The JAX package row-shards each batch over its mesh and sums the
gradients with ``psum``; one card sums once, so the weights agree to
float32 rounding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix, response_vector
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters
from h2o3_tpu_torch.parallel.mesh import any_rank
from h2o3_tpu_torch.util import jrandom as jr
from h2o3_tpu_torch.util import optim

Net = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class DeepLearningParameters(ModelParameters):
    hidden: List[int] = field(default_factory=lambda: [200, 200])
    activation: str = "rectifier"  # rectifier|tanh|maxout(≈rectifier here)
    epochs: float = 10.0
    mini_batch_size: int = 256  # reference default is 1 (Hogwild); sync steps want real batches
    adaptive_rate: bool = True  # ADADELTA (rho/epsilon), as in the reference
    rho: float = 0.99
    epsilon: float = 1e-8
    rate: float = 0.005
    rate_annealing: float = 1e-6
    momentum_start: float = 0.0
    momentum_ramp: float = 1e6  # samples over which momentum ramps (reference default)
    momentum_stable: float = 0.0
    input_dropout_ratio: float = 0.0
    hidden_dropout_ratios: Optional[List[float]] = None
    l1: float = 0.0
    l2: float = 0.0
    loss: str = "auto"  # auto|cross_entropy|quadratic|absolute
    distribution: str = "auto"
    standardize: bool = True
    autoencoder: bool = False
    score_interval: int = 1  # epochs between scoring events


def _activation(name: str):
    return {
        "rectifier": torch.relu,
        "relu": torch.relu,
        "tanh": torch.tanh,
        "maxout": torch.relu,  # maxout pieces degrade to relu, as in the JAX package
    }[name]


def _init_params(key: jr.Key, sizes: Sequence[int], device) -> Net:
    """He-uniform init (UniformAdaptive initial_weight_distribution)."""
    params = []
    for i in range(len(sizes) - 1):
        key, sub = jr.split(key)
        fan_in, fan_out = sizes[i], sizes[i + 1]
        bound = float(np.sqrt(np.float32(6.0 / (fan_in + fan_out))))  # float32 sqrt
        W = jr.uniform(sub, (fan_in, fan_out), device, -bound, bound)
        params.append((W, torch.zeros(fan_out, dtype=torch.float32, device=W.device)))
    return params


def _dropout(h: torch.Tensor, key: jr.Key, ratio: float) -> torch.Tensor:
    keep = jr.bernoulli(key, 1 - ratio, h.shape, h.device)
    return torch.where(keep, h / (1 - ratio), 0.0)


def _forward(params: Net, x: torch.Tensor, act, dropout_key: Optional[jr.Key] = None,
             input_dropout: float = 0.0,
             hidden_dropout: Optional[Sequence[float]] = None) -> torch.Tensor:
    h = x
    if dropout_key is not None and input_dropout > 0:
        dropout_key, sub = jr.split(dropout_key)
        h = _dropout(h, sub, input_dropout)
    n_layers = len(params)
    for i, (W, b) in enumerate(params):
        h = h @ W + b
        if i < n_layers - 1:
            h = act(h)
            if dropout_key is not None and hidden_dropout is not None and hidden_dropout[i] > 0:
                dropout_key, sub = jr.split(dropout_key)
                h = _dropout(h, sub, hidden_dropout[i])
    return h


def _on_device(net_params, device) -> Net:
    """The layers as float32 tensors on ``device``, copies of the arrays."""
    return [tuple(torch.from_numpy(np.array(a, dtype=np.float32)).to(device) for a in layer)
            for layer in net_params]


class DeepLearningModel(Model):
    algo_name = "deeplearning"

    def __init__(self, params, data_info, loss_kind: str, device: torch.device):
        super().__init__(params, data_info, device)
        #: [(W, b)] per layer as float32 numpy arrays
        self.net_params = None
        self.loss_kind = loss_kind
        self.epochs_trained = 0.0
        #: optax's state leaves as numpy arrays (util/optim.py), kept so a
        #: checkpoint continues the accumulators, traces and counts exactly
        self.opt_leaves = None
        #: fit wall seconds: ``epoch_s`` (one per epoch run, the device
        #: synchronized at each epoch's end), ``steps_per_epoch``, ``batch``
        self.timings: dict = {}

    def _forward_np(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float32)
        with torch.no_grad():
            out = _forward(_on_device(self.net_params, self.device),
                           torch.from_numpy(X).to(self.device),
                           _activation(self.params.activation))
        return out.cpu().numpy()

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        out = self._forward_np(frame)
        if self.params.autoencoder:
            return out
        if self.is_classifier:
            z = out - out.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        return out[:, 0]

    def predict(self, frame: Frame) -> Frame:
        if not self.params.autoencoder:
            return super().predict(frame)
        # reconstruction frame, one column per design-matrix coefficient
        # (DeepLearningModel scoreAutoEncoder reconstruction output)
        rec = self._forward_np(frame)
        names = self.data_info.coef_names
        return Frame(
            [Column(f"reconstr_{names[i]}", rec[:, i].astype(np.float64), ColType.NUM)
             for i in range(rec.shape[1])]
        )

    def anomaly(self, frame: Frame) -> np.ndarray:
        """Autoencoder per-row reconstruction MSE (DeepLearningModel
        scoreAutoEncoder)."""
        assert self.params.autoencoder, "anomaly() requires autoencoder=True"
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float32)
        rec = self._forward_np(frame)
        return ((rec - X) ** 2).mean(axis=1)


def loss_kind(p: DeepLearningParameters, nclasses: int) -> str:
    """The loss a fit trains with: quadratic for the autoencoder,
    cross-entropy for a classifier, else ``p.loss`` (quadratic by default)."""
    if p.autoencoder:
        return "quadratic"
    if nclasses > 1:
        return "cross_entropy"
    return "quadratic" if p.loss in ("auto", "quadratic") else p.loss


def make_optimizer(p: DeepLearningParameters) -> optim.Optimizer:
    """The optimizer the JAX package builds from these parameters."""
    if p.adaptive_rate:
        return optim.Adadelta(learning_rate=1.0, rho=p.rho, eps=p.epsilon)
    sched = (
        optim.ExponentialDecay(p.rate, 1, 1.0 / (1.0 + p.rate_annealing))
        if p.rate_annealing > 0
        else p.rate
    )
    if (p.momentum_start > 0) or (p.momentum_stable > 0):
        # momentum ramps linearly from start to stable over momentum_ramp
        # samples (Neurons momentum(), momentum_ramp param), in float32
        mbs = torch.tensor(float(p.mini_batch_size), dtype=torch.float32)
        ramp = torch.tensor(max(p.momentum_ramp, 1.0), dtype=torch.float32)
        start = torch.tensor(p.momentum_start, dtype=torch.float32)
        span = torch.tensor(p.momentum_stable - p.momentum_start, dtype=torch.float32)

        def mom_sched(step: int) -> torch.Tensor:
            samples = torch.tensor(step, dtype=torch.float32) * mbs
            frac = torch.clamp(samples / ramp, 0.0, 1.0)
            return torch.addcmul(start, span, frac)

        return optim.InjectMomentum(sched, mom_sched)
    return optim.SGD(sched)


class DeepLearning(ModelBuilder):

    SUPPORTED_COMMON = frozenset(
        {"stopping_rounds", "checkpoint", "max_runtime_secs"}
    )
    algo_name = "deeplearning"

    def __init__(self, params: Optional[DeepLearningParameters] = None, **kw) -> None:
        super().__init__(params or DeepLearningParameters(**kw))

    def _resolve_checkpoint(self, info, kind: str):
        """checkpoint-continue (CheckpointUtils): the non-modifiable
        parameters must match; returns the prior model. ``epochs`` is the
        TOTAL target, like the trees' ``ntrees``."""
        p = self.params
        if not p.checkpoint:
            return None
        from h2o3_tpu_torch.keyed import DKV

        prior = DKV.get(p.checkpoint)
        if prior is None:
            raise ValueError(f"checkpoint model {p.checkpoint!r} not found")
        if getattr(prior, "algo_name", None) != self.algo_name:
            raise ValueError("checkpoint model is not a deeplearning model")
        pp = prior.params
        for f in ("hidden", "activation", "adaptive_rate", "standardize",
                  "autoencoder", "mini_batch_size"):
            if getattr(pp, f) != getattr(p, f):
                raise ValueError(
                    f"checkpoint {f}={getattr(pp, f)!r} differs from "
                    f"requested {getattr(p, f)!r}"
                )
        if prior.data_info.coef_names != info.coef_names:
            raise ValueError("checkpoint design-matrix layout differs from this frame")
        if prior.data_info.response_domain != info.response_domain:
            # different classes (or order) would gather out-of-range labels
            # against the prior output layer
            raise ValueError("checkpoint response domain differs from this frame")
        if prior.loss_kind != kind:
            raise ValueError("checkpoint loss differs from this training setup")
        if p.epochs <= prior.epochs_trained:
            raise ValueError(
                f"checkpoint already has {prior.epochs_trained} epochs; "
                f"epochs={p.epochs} must exceed it"
            )
        return prior

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> DeepLearningModel:
        from h2o3_tpu_torch.frame import devcache

        p: DeepLearningParameters = self.params
        info = build_data_info(
            frame,
            y=None if p.autoencoder else p.response_column,
            ignored=p.ignored_columns,
            standardize=p.standardize,
            use_all_factor_levels=True,
        )
        X, _ = expand_matrix(info, frame, dtype=np.float32)
        n, d_in = X.shape

        if p.autoencoder:
            nclasses, d_out = 1, d_in
            Y = X
        else:
            y = response_vector(info, frame)
            keep = ~np.isnan(y)
            X, y = X[keep], y[keep]
            n = len(y)
            nclasses = len(info.response_domain) if info.response_domain else 1
            d_out = nclasses
            Y = y.astype(np.int64) if nclasses > 1 else y.astype(np.float32)
        kind = loss_kind(p, nclasses)

        # resolve (and validate) the checkpoint BEFORE constructing the
        # model: Model.__init__ registers in the DKV, and a failed
        # validation must not leak a phantom untrained model
        prior = self._resolve_checkpoint(info, kind)
        model = DeepLearningModel(p, info, kind, device)
        act = _activation(p.activation)
        sizes = [d_in] + list(p.hidden) + [d_out]
        base_seed = p.actual_seed()
        base_key = jr.PRNGKey(base_seed)
        if prior is not None:
            net = _on_device(prior.net_params, device)
        else:
            _, init_key = jr.split(base_key)
            net = _init_params(init_key, sizes, device)
        flat = [t for layer in net for t in layer]

        opt = make_optimizer(p)
        opt_state = opt.init(flat)
        # getattr: models saved before opt_leaves existed decode without it
        if prior is not None and getattr(prior, "opt_leaves", None) is not None:
            # resume the optimizer exactly (accumulators + step counters)
            if len(prior.opt_leaves) != opt.num_leaves(len(flat)):
                raise ValueError("checkpoint optimizer state is incompatible")
            opt_state = [
                torch.from_numpy(np.array(leaf)) if np.ndim(leaf) == 0
                else torch.from_numpy(np.array(leaf)).to(device)
                for leaf in prior.opt_leaves
            ]

        hidden_do = tuple(p.hidden_dropout_ratios) if p.hidden_dropout_ratios else None

        def loss_fn(flat_params, xb, yb, dk):
            layers = list(zip(flat_params[0::2], flat_params[1::2]))
            out = _forward(layers, xb, act, dk, p.input_dropout_ratio, hidden_do)
            if kind == "cross_entropy":
                data_loss = optim.softmax_cross_entropy_with_integer_labels(out, yb).mean()
            elif kind == "absolute":
                data_loss = (out[:, 0] - yb).abs().mean()
            elif p.autoencoder:
                data_loss = ((out - yb) ** 2).mean()
            else:
                data_loss = ((out[:, 0] - yb) ** 2).mean()
            if not (p.l1 or p.l2):
                return data_loss  # the JAX package adds 0 * |W|, which adds nothing
            reg = 0.0
            for W in flat_params[0::2]:
                reg = reg + ((p.l1 * W.abs().sum() if p.l1 else 0.0)
                             + (p.l2 * (W ** 2).sum() if p.l2 else 0.0))
            return data_loss + reg

        def train_step(flat, opt_state, xb, yb, dk):
            params = [t.detach().requires_grad_(True) for t in flat]
            loss = loss_fn(params, xb, yb, dk)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                updates, opt_state = opt.update(grads, opt_state, flat)
                flat = optim.apply_updates(flat, updates)
            return flat, opt_state, loss.detach()

        Xd, Yd = devcache.cached(
            "deeplearning_train", devcache.frame_token(frame),
            (p.standardize, p.autoencoder, tuple(p.ignored_columns), p.response_column),
            device,
            lambda: (torch.from_numpy(X).to(device),
                     torch.from_numpy(np.ascontiguousarray(Y)).to(device)),
            frame_key=getattr(frame, "key", None),
        )
        bs = max(p.mini_batch_size, 1)  # one device: no rounding to a mesh
        steps_per_epoch = max(n // bs, 1)
        total_epochs = int(np.ceil(p.epochs))
        start_epoch = int(prior.epochs_trained) if prior is not None else 0
        history: List[float] = []
        deadline = (
            time.time() + p.max_runtime_secs if p.max_runtime_secs > 0 else None
        )
        model.timings.update(steps_per_epoch=steps_per_epoch, batch=bs, epoch_s=[])

        # RNG keyed by ABSOLUTE epoch/step index: k epochs then k more
        # reproduces a straight 2k-epoch run exactly
        loss = None
        for epoch in range(start_epoch, total_epochs):
            t_epoch = time.time()
            perm = np.random.default_rng(
                base_seed + 1_000_003 * (epoch + 1)
            ).permutation(n)
            if steps_per_epoch * bs > n:  # static shapes: cycle the permutation
                perm = np.resize(perm, steps_per_epoch * bs)
            perm_d = torch.from_numpy(perm).to(device)
            ekey = jr.fold_in(base_key, epoch + 1)
            for s in range(steps_per_epoch):
                idx = perm_d[s * bs:(s + 1) * bs]
                xb = Xd.index_select(0, idx)
                yb = Yd.index_select(0, idx)
                flat, opt_state, loss = train_step(flat, opt_state, xb, yb,
                                                   jr.fold_in(ekey, s))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            model.timings["epoch_s"].append(time.time() - t_epoch)
            model.epochs_trained = epoch + 1
            # a wall-clock budget is rank-local: with a process group live,
            # every rank (each fitting whole) stops where any rank stops
            if deadline is not None and any_rank(time.time() >= deadline):
                break
            if p.stopping_rounds > 0 and (epoch + 1) % p.score_interval == 0:
                history.append(float(loss))
                if M.stop_early(
                    history, p.stopping_rounds, more_is_better=False,
                    stopping_tolerance=p.stopping_tolerance,
                ):
                    break
            if self.job is not None:
                self.job.update((epoch + 1) / total_epochs)

        model.net_params = [(W.cpu().numpy(), b.cpu().numpy())
                            for W, b in zip(flat[0::2], flat[1::2])]
        model.opt_leaves = [leaf.cpu().numpy() for leaf in opt_state]
        if not p.autoencoder:
            model.training_metrics = model.model_performance(frame)
            if valid is not None:
                model.validation_metrics = model.model_performance(valid)
        return model
