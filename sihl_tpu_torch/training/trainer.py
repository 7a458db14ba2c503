"""Training runtime (counterpart of ``sihl_tpu/training/trainer.py``).

:class:`Trainer` runs one optimisation step per :meth:`Trainer.training_step`
on the model's device: the features once, each head's ``training_step``
with its targets, the sum of the head losses, the backward, optax's global
norm clip and the optimizer's update, then the EMA shadow's update where
``ema_decay`` is set.  It returns the metrics the JAX trainer returns,
under the same keys, as tensors on the device: nothing in the step waits
for the device unless a ``logger`` is set.

Around the step, as in the JAX package: :meth:`Trainer.fit` (a step-driven
loop with logging, validation and checkpoint cadences),
:meth:`Trainer.validate` (each head's ``validation_step`` in eval mode
without gradients, metric states on the device, ``aux`` collected on the
host, results under ``head{i}/valid/...``), :meth:`Trainer.predict`, the
EMA shadow of the parameters and the train state
(:meth:`Trainer.state_dict` / :meth:`Trainer.load_state_dict`, saved by
``sihl_tpu_torch.training.checkpoint``), and the pretraining protocol
(:meth:`Trainer.pretrain`: the heads' ``pretrain_init`` / ``pretrain_step``
/ ``pretrain_end`` in eval mode, the anomaly head's teacher statistics).
A head whose ``target_is_second_view`` is set (Barlow Twins) gets the
trunk's features of its target, a second view of the images, as one
argument, in training and in validation.

Every write into the live parameters (EMA, :meth:`Trainer.use_ema_params`,
:meth:`Trainer.load_state_dict`) is an in-place ``copy_``: the K1 pack cache
(``ops/fused_mlp.py``) keys on each parameter's storage and version, which
an in-place write bumps, so the next call repacks.

The multi-step dispatch (:meth:`Trainer.training_steps_scanned`, and
:meth:`Trainer.fit` with ``steps_per_dispatch > 1``) runs K steps from one
call.  On a CUDA model it is one CUDA graph of a whole step (the features,
the heads' losses, the backward, the clip, the optimizer's update and the
EMA) replayed K times on static input buffers, with each step's learning
rate copied into the optimizer's device tensors before its replay: the
host launches a few copies and one graph a step and waits for nothing.
The graph is captured once for each (shapes, dtypes, EMA, optimizer), after
a first step that runs eagerly as step 0 of the same dispatch (it builds the
optimizer's state, the kernels' libraries, Triton's JIT and cuDNN's
choices); :meth:`Trainer.load_state_dict` drops it.  A replay moves no
parameter's ``_version``, so the dispatch ends by emptying the K1 pack
cache.  State that a step moves lives on the card and moves in place, so
each replay moves it on: BatchNorm's running statistics, the optimizer's
state, the panoptic head's step counter, the anomaly head's reservoirs
and a ``Dropout``'s count (each replay draws a new mask, the one an eager
step at that count draws; ``layers/dropout.py``).  A step that a graph
cannot hold (a host read, a data-dependent shape, a tensor copied from
the host) makes the capture raise, naming the first operation that
failed and where the model called it; the dispatch never falls back to
eager steps.  On a CPU model the same K steps run as a loop.

A capture cannot hand memory back to the card while it runs, so the pieces
that the caching allocator splits can exhaust the card where a step's eager
peak comes near its memory: the autoencoder's step at batch 16, 640 px
(63.5 GiB live of an 80 GB H100) captures only with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in the process's
environment (read at CUDA's first allocation; ``chip_smoke.py`` sets it).
The allocator then unmaps a dropped graph's pages after waiting for the
stream it was captured on, and the replays run on the caller's stream, so
each dispatch ends by making the capture stream wait for them.

A capture runs with CUDA's thread-local capture mode: a
``DevicePrefetcher`` (``sihl_tpu_torch/data``) allocates, pins and copies
on its own stream from its worker thread while the consumer may be
capturing, and under the global mode any such call from another thread
would invalidate the capture.  What the capturing thread itself does is
checked as before.

:meth:`Trainer.training_step`, :meth:`Trainer.fit` and
:meth:`Trainer.validate` take the JAX package's host batches (numpy, NHWC
images, int32 classes) as well as tensors, through
``sihl_tpu_torch.data.to_device``.

Not ported: meshes and spatial partitioning (M19), visualization (M20) and
``remat`` (a TPU memory lever, not ported).
"""

import os
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sihl_tpu_torch.data import to_device
from sihl_tpu_torch.model import SihlModel
from sihl_tpu_torch.ops.fused_mlp import invalidate_packs
from sihl_tpu_torch.training.optim import clip_by_global_norm_, make_optimizer


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS_FILE = os.path.join("training", "trainer.py")


def _call_step(head, method: str, feats, target, state=None):
    fn = getattr(head, method)
    lead = () if state is None else (state,)
    if isinstance(target, dict):
        return fn(*lead, feats, **target)
    if isinstance(target, (tuple, list)):
        return fn(*lead, feats, *target)
    return fn(*lead, feats, *(() if target is None else (target,)))


def _second_view(model: SihlModel, head, target):
    """A ``target_is_second_view`` head's target: the trunk's features of
    the second view, as one argument (not splat)."""
    if getattr(head, "target_is_second_view", False):
        return (model.extract_features(target),)
    return target


def _losses(model: SihlModel, x: torch.Tensor, targets):
    """The sum of the heads' losses, and every head's metrics under
    ``head{i}/train/...``.  The trunk runs on ``x`` first, then on each
    second view, as in the JAX package (in training mode each run moves the
    BatchNorms' running statistics, in that order)."""
    feats = model.extract_features(x)
    losses, metrics = [], {}
    for idx, (head, target) in enumerate(zip(model.heads, targets)):
        target = _second_view(model, head, target)
        loss, head_metrics = _call_step(head, "training_step", feats, target)
        losses.append(loss)
        metrics[f"head{idx}/train/loss"] = loss
        for k, v in head_metrics.items():
            metrics[f"head{idx}/train/{k}"] = v
    return torch.stack(losses).sum(), metrics


def _eval_step(model: SihlModel, metric_states, x: torch.Tensor, targets):
    """Each head's ``validation_step`` on the shared features: the new metric
    states, the sum of the losses and each head's ``aux``."""
    feats = model.extract_features(x)
    new_states, losses, auxes = [], [], []
    for head, state, target in zip(model.heads, metric_states, targets):
        target = _second_view(model, head, target)
        state, loss, aux = _call_step(head, "validation_step", feats, target, state=state)
        new_states.append(state)
        losses.append(loss)
        auxes.append(aux)
    return new_states, torch.stack(losses).sum(), auxes


def _pretrain_step(model: SihlModel, pre_states, x: torch.Tensor, targets):
    """Each head's ``pretrain_step`` on the shared features, for the heads
    that have a pretraining state; the new states."""
    feats = model.extract_features(x)
    new_states = []
    for head, state, target in zip(model.heads, pre_states, targets):
        if state is None or not hasattr(head, "pretrain_step"):
            new_states.append(state)
            continue
        new_states.append(_call_step(head, "pretrain_step", feats, target, state=state))
    return new_states


def _to_host(tree):
    """``tree`` with every tensor as a numpy array: one batch of
    device-to-host copies and one wait for them (``jax.device_get``)."""
    copies = []

    def start(node):
        if isinstance(node, dict):
            return {k: start(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(start(v) for v in node)
        if isinstance(node, torch.Tensor):
            copies.append(node.is_cuda)
            return node.detach().to("cpu", non_blocking=True)
        return node

    def finish(node):
        if isinstance(node, dict):
            return {k: finish(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(finish(v) for v in node)
        if isinstance(node, torch.Tensor):
            return node.numpy()
        return node

    started = start(tree)
    if any(copies):
        torch.cuda.current_stream().synchronize()
    return finish(started)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def _map_tree(fn, *trees):
    """``fn`` over the tensors at the same places of ``trees`` (dicts, lists
    and tuples of tensors); anything else is taken from the first tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_tree(fn, *parts) for parts in zip(*trees))
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


class _FailingOp(TorchDispatchMode):
    """Names the first operation that raises while it is active (the aten
    op and the innermost frame of the model's code that called it), as
    :attr:`where`; a capture reports it."""

    def __init__(self):
        super().__init__()
        self.where: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except Exception:
            if self.where is None:
                frames = [f for f in traceback.extract_stack()
                          if _PACKAGE in f.filename and not f.filename.endswith(_THIS_FILE)]
                site = f" at {frames[-1].filename}:{frames[-1].lineno}" if frames else ""
                self.where = f"{func}{site}"
            raise


class _StepGraph(NamedTuple):
    """One captured training step: what it was captured for, the graph, the
    stream it was captured on, its static inputs, and the metrics it writes
    (one f32 vector, ``keys`` in order, cast back to ``dtypes``)."""

    key: Any
    graph: Any
    stream: Any
    x: torch.Tensor
    targets: list
    vector: torch.Tensor
    keys: List[str]
    dtypes: List[torch.dtype]


class Trainer:
    def __init__(
        self,
        model: SihlModel,
        optimizer: str = "adam",
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[Dict[str, Any]] = None,
        data_config: Optional[List[Dict[str, Any]]] = None,
        hyperparameters: Optional[Dict[str, Any]] = None,
        grad_clip: Optional[float] = None,
        mesh=None,
        spatial_partition: bool = False,
        remat: bool = False,
        ema_decay: Optional[float] = None,
        logger: Optional[Callable[[Dict[str, float], int], None]] = None,
        viz_logger=None,
        viz_every: int = 0,
    ):
        if mesh is not None or spatial_partition:
            raise _not_ported("a mesh and spatial partitioning (multi-GPU)", "M19")
        if viz_logger is not None or viz_every:
            raise _not_ported("visualization (viz_logger, viz_every)", "M20")
        if remat:
            raise NotImplementedError(
                "remat=True is a TPU memory lever that the port leaves out (ROADMAP.md, queue A, 'Do not port')"
            )
        self.model = model
        # kept for the JAX trainer's signature: only visualization (M20) reads it
        self.data_config = data_config or [{} for _ in model.heads]
        if isinstance(self.data_config, dict):
            self.data_config = [self.data_config]
        self.hyperparameters = hyperparameters
        self.logger = logger
        self.optimizer, self.schedule = make_optimizer(
            model, optimizer, optimizer_kwargs, scheduler, scheduler_kwargs
        )
        self.grad_clip = grad_clip
        self.step = 0
        self.ema_decay = ema_decay
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay:
            # a shadow of the parameters only (no BatchNorm running statistics)
            self.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._graph: Optional[_StepGraph] = None
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "eager_steps": 0, "replays": 0}

    # -- train -------------------------------------------------------------
    def _apply_frozen_bn(self) -> None:
        backbone = self.model.backbone
        if getattr(backbone, "freeze_batchnorms", False) and getattr(backbone, "frozen_levels", 0):
            backbone._set_frozen_bn_eval()

    def _on_device(self, x, targets):
        """A batch as the model takes it: a host batch in the JAX package's
        layout (numpy, NHWC images) through :func:`~sihl_tpu_torch.data.to_device`
        to the model's device; tensors unchanged."""
        return to_device((x, targets), next(self.model.parameters()).device)

    def training_step(self, x: torch.Tensor, targets=None) -> Dict[str, Any]:
        """One optimisation step on a batch of (B, C, H, W) images (or a host
        batch of NHWC numpy images, moved by :func:`to_device`); ``targets``
        is one head's targets (a dict splats as keyword arguments) or a list
        of them, one per head.  Returns the step's metrics."""
        x, targets = self._on_device(x, targets)
        if not isinstance(targets, list):
            targets = [targets]
        self.model.train()
        self._apply_frozen_bn()
        lr = self._set_learning_rate(self.step)
        metrics = self._step_body(x, targets)
        metrics["trainer/learning_rate"] = lr
        self.step += 1
        if self.logger is not None:
            self.logger({k: float(v) for k, v in metrics.items()}, self.step)
        return metrics

    def _step_body(self, x: torch.Tensor, targets: list) -> Dict[str, torch.Tensor]:
        """The step at the learning rates already set, with no host sync:
        the losses, the backward and :meth:`_update`.  A CUDA graph captures
        exactly this.  Every parameter's gradient starts anew, the frozen
        ones' too (in no optimizer group, a trunk without a gradient cut
        still gives them one, which the clip's norm counts, as the JAX
        trainer's does: one step's, not a sum over steps)."""
        self.model.zero_grad(set_to_none=True)
        loss, metrics = _losses(self.model, x, targets)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["trainer/loss"] = loss.detach()
        self._update()
        return metrics

    def apply_gradients(self) -> float:
        """Clip the gradients the parameters hold and update the parameters
        at this step's learning rate, which it returns; update the EMA
        shadow; count the step."""
        lr = self._set_learning_rate(self.step)
        self._update()
        self.step += 1
        return lr

    def _set_learning_rate(self, step: int) -> float:
        """Write ``schedule(step) * lr_scale`` into each parameter group (a
        fill of its device tensor on the card); return ``schedule(step)``."""
        lr = self.schedule(step)
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr * group["lr_scale"])
            else:
                group["lr"] = lr * group["lr_scale"]
        return lr

    def _update(self) -> None:
        """The clip, the optimizer's update and the EMA's, at the learning
        rates the groups hold."""
        if self.grad_clip:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip)
        self.optimizer.step()
        if self.ema_params is not None:
            self._ema_update()

    @torch.no_grad()
    def _ema_update(self) -> None:
        """``e * decay + p * (1 - decay)`` for every parameter, in place, with
        ``decay`` and ``1 - decay`` in f32, as the JAX trainer's jitted
        ``_ema_update`` computes them (``decay`` reaches it as an f32
        argument, so ``1 - 0.999`` is f32(1) - f32(0.999)).  ``decay`` is
        filled on the device, so a CUDA graph can hold the update."""
        named = dict(self.model.named_parameters())
        shadow = list(self.ema_params.values())
        decay = torch.full((), self.ema_decay, dtype=torch.float32, device=shadow[0].device)
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, torch._foreach_mul([named[n].detach() for n in self.ema_params], 1 - decay))

    # -- the multi-step dispatch ----------------------------------------------
    def training_steps_scanned(self, xs: torch.Tensor, targets_stacked) -> Dict[str, torch.Tensor]:
        """K optimizer steps from one call: ``xs`` is (K, B, C, H, W) and
        ``targets_stacked`` the targets (one head's, or a list of them) with
        a leading K axis on every tensor.  Returns every step's metrics
        stacked to (K,) on the model's device, under the keys of
        :meth:`training_step` but ``trainer/learning_rate`` (as the JAX
        trainer's), and advances :attr:`step` by K.  Calls no logger.

        On a CUDA model the steps are replays of one captured CUDA graph
        (the module docstring says how), each step's inputs copied into the
        graph's static buffers (inputs on the host are moved to the card
        first, which waits for them); a model whose step a graph cannot
        hold raises, with the reason.  On a CPU model they run as a loop."""
        if not isinstance(targets_stacked, list):
            targets_stacked = [targets_stacked]
        num_steps = xs.shape[0]
        self.model.train()
        self._apply_frozen_bn()
        if next(self.model.parameters()).is_cuda:
            stacked = self._replayed_steps(xs, targets_stacked)
        else:
            rows = []
            for k in range(num_steps):
                self._set_learning_rate(self.step)
                rows.append(self._step_body(xs[k], _map_tree(lambda t: t[k], targets_stacked)))
                self.step += 1
            stacked = {key: torch.stack([row[key] for row in rows]) for key in rows[0]}
        invalidate_packs()
        return stacked

    def _replayed_steps(self, xs: torch.Tensor, targets_stacked: list) -> Dict[str, torch.Tensor]:
        device = next(self.model.parameters()).device
        xs = xs.to(device, non_blocking=True)
        targets_stacked = _map_tree(lambda t: t.to(device, non_blocking=True), targets_stacked)
        num_steps, base, first = xs.shape[0], self.step, 0
        x0, targets0 = xs[0], _map_tree(lambda t: t[0], targets_stacked)
        signature = _map_tree(lambda t: (t.shape, t.dtype, t.device), [x0, targets0])
        key = (signature, self.ema_params is not None, id(self.optimizer), self.grad_clip)
        if self._graph is None or self._graph.key != key:
            self._graph = None
            self._check_capturable(device)
            stream = torch.cuda.Stream(device)
            eager = self._warm_step(stream, x0, targets0)
            self.step, first = base + 1, 1
            self._capture(stream, x0, targets0, key)
        graph, groups = self._graph, self.optimizer.param_groups
        rates = [[self.schedule(base + k) * g["lr_scale"] for g in groups] for k in range(num_steps)]
        rates = torch.tensor(rates, dtype=torch.float32).pin_memory().to(xs.device, non_blocking=True)
        out = torch.empty((num_steps, len(graph.keys)), dtype=torch.float32, device=xs.device)
        if first:
            out[0] = torch.stack([eager[k].float() for k in graph.keys])
        for k in range(first, num_steps):
            graph.x.copy_(xs[k])
            _map_tree(lambda static, t: static.copy_(t[k]), graph.targets, targets_stacked)
            for i, group in enumerate(groups):
                group["lr"].copy_(rates[k, i])
            graph.graph.replay()
            out[k].copy_(graph.vector)
        # the graph's pool belongs to its capture stream, which the allocator
        # waits for before it unmaps a dropped graph's pages (expandable
        # segments); the replays run on this stream, so that one waits for them
        graph.stream.wait_stream(torch.cuda.current_stream(xs.device))
        self.graph_stats["replays"] += num_steps - first
        self.step = base + num_steps
        return {k: out[:, i].to(dtype) for i, (k, dtype) in enumerate(zip(graph.keys, graph.dtypes))}

    def _check_capturable(self, device: torch.device) -> None:
        """Raise where a CUDA graph cannot hold this trainer's step."""
        for group in self.optimizer.param_groups:
            if not (isinstance(group["lr"], torch.Tensor) and group["lr"].device == device):
                raise RuntimeError(f"a CUDA graph needs each parameter group's learning rate as a tensor on {device}")

    def _warm_step(self, stream: torch.cuda.Stream, x: torch.Tensor, targets: list) -> Dict[str, torch.Tensor]:
        """Step ``self.step`` eagerly on ``stream``, the stream the capture
        will use (the warm-up CUDA graphs ask for): it builds what a capture
        must find built.  Returns its metrics."""
        current = torch.cuda.current_stream(x.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._set_learning_rate(self.step)
            metrics = self._step_body(x, targets)
        current.wait_stream(stream)
        self.graph_stats["eager_steps"] += 1
        return metrics

    def _capture(self, stream: torch.cuda.Stream, x: torch.Tensor, targets: list, key) -> None:
        """Capture one step on static copies of ``(x, targets)`` into
        :attr:`_graph`."""
        static_x, static_targets = x.clone(), _map_tree(torch.clone, targets)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        watch = _FailingOp()
        try:
            # a DevicePrefetcher's worker may allocate, pin and copy on its own
            # stream meanwhile: only this thread's calls can invalidate the capture
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"), watch:
                metrics = self._step_body(static_x, static_targets)
                vector = torch.stack([v.float() for v in metrics.values()])
        except RuntimeError as err:
            raise RuntimeError(
                f"the training step could not be captured in a CUDA graph: {watch.where or 'outside an operation'}: "
                f"{err}") from err
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        self._graph = _StepGraph(key, graph, stream, static_x, static_targets, vector, list(metrics),
                                 [v.dtype for v in metrics.values()])

    def fit(
        self,
        train_data,
        num_steps: int,
        val_data=None,
        val_every: Optional[int] = None,
        log_every: int = 50,
        steps_per_dispatch: int = 1,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> Dict[str, float]:
        """Step-driven fit loop over an iterator of ``(x, targets)``: tensors,
        or host batches in the JAX package's layout (numpy, NHWC images;
        :func:`~sihl_tpu_torch.data.to_device` moves them, and a
        :class:`~sihl_tpu_torch.data.DevicePrefetcher` hands them over moved).

        ``steps_per_dispatch = K > 1`` stacks K batches (on their device)
        and runs them through :meth:`training_steps_scanned`; after each
        dispatch the logger gets its last step's metrics with
        ``trainer/learning_rate`` at the step count the dispatch ends on, as
        the JAX trainer logs them.  Every ``log_every`` steps (every
        dispatch that crosses a multiple of it) the step's metrics become
        floats (the only host syncs of the loop, apart from a logger's) with
        ``trainer/steps_per_sec``: the steps taken since the last log (or
        since the call began) over their time.  The JAX trainer divides
        ``log_every`` instead, which overstates the first reading of a call
        that starts off the cadence.  Every ``val_every`` steps
        :meth:`validate` runs on ``val_data`` (re-iterated each time); every
        ``checkpoint_every`` steps the train state is saved to
        ``checkpoint_dir/step_N``, and once more when fitting ends.  Returns
        the last logged metrics with the last validation's."""
        it = iter(train_data)
        last_metrics: Dict[str, float] = {}
        t0, since_log, done = time.perf_counter(), 0, 0
        while done < num_steps:
            k = min(steps_per_dispatch, num_steps - done)
            if steps_per_dispatch > 1:
                batches = [self._on_device(*next(it)) for _ in range(k)]
                xs = torch.stack([b[0] for b in batches])
                targets = [b[1] if isinstance(b[1], list) else [b[1]] for b in batches]
                scanned = self.training_steps_scanned(xs, _map_tree(lambda *ts: torch.stack(ts), *targets))
                metrics = {key: v[-1] for key, v in scanned.items()}
                metrics["trainer/learning_rate"] = self.schedule(self.step)
                if self.logger is not None:
                    self.logger({key: float(v) for key, v in metrics.items()}, self.step)
            else:
                x, targets = next(it)
                metrics = self.training_step(x, targets)
            done += k
            since_log += k
            if self.step % log_every < steps_per_dispatch:
                last_metrics = {key: float(v) for key, v in metrics.items()}
                last_metrics["trainer/steps_per_sec"] = since_log / max(time.perf_counter() - t0, 1e-9)
                t0, since_log = time.perf_counter(), 0
            if val_data is not None and val_every and self.step % val_every < steps_per_dispatch:
                last_metrics.update(self.validate(val_data))
            if checkpoint_every and checkpoint_dir and self.step % checkpoint_every < steps_per_dispatch:
                self._save_checkpoint(checkpoint_dir)
        if checkpoint_every and checkpoint_dir:
            self._save_checkpoint(checkpoint_dir)
        return last_metrics

    def _save_checkpoint(self, checkpoint_dir: str) -> None:
        from sihl_tpu_torch.training.checkpoint import save_checkpoint

        os.makedirs(checkpoint_dir, exist_ok=True)
        save_checkpoint(self, os.path.join(checkpoint_dir, f"step_{self.step}"))

    # -- validation ---------------------------------------------------------
    def validate(self, val_data) -> Dict[str, float]:
        """Each head's metrics over ``val_data`` (an iterable of ``(x,
        targets)``, tensors or host batches as :meth:`fit` takes them) under
        ``head{i}/valid/...``.  Runs in eval mode under
        ``torch.no_grad()`` (not inference mode: a K1 weight pack built in
        inference mode could not be saved for a later training step's
        backward), so BatchNorm's running statistics do not move."""
        self.model.eval()
        heads = list(self.model.heads)
        for head in heads:
            if hasattr(head, "on_validation_start"):
                head.on_validation_start()
        states = [head.metrics_init() for head in heads]
        collected: List[list] = [[] for _ in heads]
        with torch.no_grad():
            for x, targets in val_data:
                x, targets = self._on_device(x, targets)
                if not isinstance(targets, list):
                    targets = [targets]
                states, _, auxes = _eval_step(self.model, states, x, targets)
                for idx, aux in enumerate(_to_host(auxes)):
                    if aux:
                        collected[idx].append(aux)
        metrics = {}
        for idx, (head, state) in enumerate(zip(heads, states)):
            for k, v in head.validation_end(state, collected[idx]).items():
                metrics[f"head{idx}/valid/{k}"] = v
        if self.logger is not None:
            self.logger(metrics, self.step)
            if self.hyperparameters and hasattr(self.logger, "log_hyperparams"):
                self.logger.log_hyperparams(self.hyperparameters, metrics, self.step)
        return metrics

    # -- pretraining protocol (the anomaly head's teacher statistics) --------
    @torch.no_grad()
    def pretrain(self, data) -> None:
        """Run the heads' pretraining protocol over ``data`` (an iterable of
        ``(x, targets)``) in eval mode without gradients: ``pretrain_init``,
        ``pretrain_step`` for every batch, ``pretrain_end``.  Nothing happens
        when no head has a ``pretrain_init``.  The next
        :meth:`training_step` returns the model to training mode."""
        self.model.eval()
        states = [head.pretrain_init() if hasattr(head, "pretrain_init") else None for head in self.model.heads]
        if all(s is None for s in states):
            return
        for x, targets in data:
            if not isinstance(targets, list):
                targets = [targets]
            states = _pretrain_step(self.model, states, x, targets)
        for head, state in zip(self.model.heads, states):
            if state is not None and hasattr(head, "pretrain_end"):
                head.pretrain_end(state)

    @torch.no_grad()
    def use_ema_params(self) -> None:
        """Copy the EMA shadow into the live model, in place (e.g. before export)."""
        assert self.ema_params is not None
        for name, p in self.model.named_parameters():
            p.copy_(self.ema_params[name])

    # -- inference -----------------------------------------------------------
    def predict(self, x: torch.Tensor):
        self.model.eval()
        with torch.no_grad():
            return self.model(x)

    # -- state access (for checkpointing) ------------------------------------
    def sync_model(self) -> None:
        """Nothing to do: the live parameters are always current.  A
        scanned dispatch updates them in place, in the graph or in the loop,
        where the JAX trainer's keeps them in a carry that this writes
        back."""

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> Dict[str, Any]:
        """The train state: ``model`` (parameters and BatchNorm buffers),
        ``opt`` (the optimizer's ``state_dict``), ``step`` and, with an EMA,
        ``ema``.  Its tensors are the live ones, as ``nn.Module.state_dict``
        returns them."""
        out = {
            "model": self.model.state_dict(),
            "opt": self.optimizer.state_dict(),
            "step": self.step,
        }
        if self.ema_params is not None:
            # the EMA shadow is train state too: losing it on resume would
            # restart the average from the live params
            out["ema"] = dict(self.ema_params)
        return out

    @torch.no_grad()
    def load_state_dict(self, state) -> None:
        """Load a :meth:`state_dict` into the live model, optimizer and EMA
        shadow, each by an in-place copy (strict on the model's keys).  The
        optimizer's state and learning rates are new tensors then, so a
        captured step graph is dropped (the JAX trainer drops its scan
        runner) and the next dispatch captures anew."""
        self._graph = None
        self.model.load_state_dict(state["model"], strict=True)
        rates = [g["lr"] for g in self.optimizer.param_groups]
        # the optimizer keeps loaded tensors that already sit on the right
        # device and dtype as they are; clone them, so that two trainers
        # never share optimizer state
        self.optimizer.load_state_dict(_clone_tensors(state["opt"]))
        for group, rate in zip(self.optimizer.param_groups, rates):
            # the learning rate stays a tensor on the card, a float on the CPU
            if isinstance(rate, torch.Tensor):
                group["lr"] = rate.copy_(torch.as_tensor(group["lr"]))
            else:
                group["lr"] = float(group["lr"])
        if self.ema_params is not None and "ema" in state:
            for name, e in self.ema_params.items():
                e.copy_(state["ema"][name])
        self.step = int(state["step"])


def _clone_tensors(tree):
    if isinstance(tree, dict):
        return {k: _clone_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tensors(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree
