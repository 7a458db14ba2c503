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

Not ported: the scanned multi-step dispatch (``steps_per_dispatch > 1``,
ROADMAP.md M9b), meshes and spatial partitioning (M19), visualization
(M20) and ``remat`` (a TPU memory lever, not ported).
"""

import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from sihl_tpu_torch.model import SihlModel
from sihl_tpu_torch.training.optim import clip_by_global_norm_, make_optimizer


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

    # -- train -------------------------------------------------------------
    def _apply_frozen_bn(self) -> None:
        backbone = self.model.backbone
        if getattr(backbone, "freeze_batchnorms", False) and getattr(backbone, "frozen_levels", 0):
            backbone._set_frozen_bn_eval()

    def training_step(self, x: torch.Tensor, targets=None) -> Dict[str, Any]:
        """One optimisation step on a batch of (B, C, H, W) images; ``targets``
        is one head's targets (a dict splats as keyword arguments) or a list
        of them, one per head.  Returns the step's metrics."""
        if not isinstance(targets, list):
            targets = [targets]
        self.model.train()
        self._apply_frozen_bn()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = _losses(self.model, x, targets)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["trainer/loss"] = loss.detach()
        metrics["trainer/learning_rate"] = self.apply_gradients()
        if self.logger is not None:
            self.logger({k: float(v) for k, v in metrics.items()}, self.step)
        return metrics

    def apply_gradients(self) -> float:
        """Clip the gradients the parameters hold and update the parameters
        at this step's learning rate, which it returns; update the EMA
        shadow; count the step."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        if self.grad_clip:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip)
        self.optimizer.step()
        if self.ema_params is not None:
            self._ema_update()
        self.step += 1
        return lr

    @torch.no_grad()
    def _ema_update(self) -> None:
        """``e * decay + p * (1 - decay)`` for every parameter, in place, with
        ``decay`` and ``1 - decay`` in f32, as the JAX trainer's jitted
        ``_ema_update`` computes them (``decay`` reaches it as an f32
        argument, so ``1 - 0.999`` is f32(1) - f32(0.999))."""
        named = dict(self.model.named_parameters())
        shadow = list(self.ema_params.values())
        decay = torch.tensor(self.ema_decay, dtype=torch.float32, device=shadow[0].device)
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, torch._foreach_mul([named[n].detach() for n in self.ema_params], 1 - decay))

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
        """Step-driven fit loop over an iterator of ``(x, targets)``.

        Every ``log_every`` steps the step's metrics become floats (the
        only host syncs of the loop, apart from a logger's) with
        ``trainer/steps_per_sec``: the steps taken since the last log (or
        since the call began) over their time.  The JAX trainer divides
        ``log_every`` instead, which overstates the first reading of a call
        that starts off the cadence.  Every ``val_every``
        steps :meth:`validate` runs on ``val_data`` (re-iterated each
        time); every ``checkpoint_every`` steps the train state is saved to
        ``checkpoint_dir/step_N``, and once more when fitting ends.
        Returns the last logged metrics with the last validation's."""
        if steps_per_dispatch > 1:
            raise _not_ported("steps_per_dispatch > 1 (the scanned multi-step dispatch)", "M9b")
        it = iter(train_data)
        last_metrics: Dict[str, float] = {}
        t0, since_log = time.perf_counter(), 0
        for _ in range(num_steps):
            x, targets = next(it)
            metrics = self.training_step(x, targets)
            since_log += 1
            if self.step % log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                last_metrics["trainer/steps_per_sec"] = since_log / max(time.perf_counter() - t0, 1e-9)
                t0, since_log = time.perf_counter(), 0
            if val_data is not None and val_every and self.step % val_every == 0:
                last_metrics.update(self.validate(val_data))
            if checkpoint_every and checkpoint_dir and self.step % checkpoint_every == 0:
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
        targets)``) under ``head{i}/valid/...``.  Runs in eval mode under
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
        """Nothing to do: the live model always holds the parameters.  (The
        JAX trainer's scanned dispatch keeps them in a carry that this
        writes back; the port's comes with ROADMAP.md M9b.)"""

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
        shadow, each by an in-place copy (strict on the model's keys)."""
        self.model.load_state_dict(state["model"], strict=True)
        # the optimizer keeps loaded tensors that already sit on the right
        # device and dtype as they are; clone them, so that two trainers
        # never share optimizer state
        self.optimizer.load_state_dict(_clone_tensors(state["opt"]))
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
