"""Training loop over ``nn.Module`` models (port of
``vaemolsim_tpu/train/loop.py``).

The loss is a callable ``loss_fn(model, batch, generator) -> scalar |
(scalar, metrics)``; one step is forward, ``loss.backward()`` and
``optimizer.step()``, updating the model in place.  Batching drops the
remainder, so every batch has the same shape.  ``data`` is a tensor or
a tuple / list / dict of tensors sharing the leading (sample) axis.

``data`` may instead be a callable ``data(generator) -> iterable of
batches``, a stream drawn anew each epoch.  ``fit_ensemble`` trains K
models of one structure side by side on the same batches, each with its
own optimizer and generator; it runs the K members one after another
within each step (the JAX package ``vmap``s them into one program; a
member-batched program is a ROADMAP.md item).  Sharded training
(``mesh``, ``process_local_data``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["fit", "fit_ensemble", "make_train_step", "stack_models",
           "unstack_model"]

# History keys that a loss's metrics may not overwrite (elbo_loss's own
# "loss" metric duplicates the total).
_RESERVED = ("loss", "epoch_time_s")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to vaemolsim_tpu_torch yet (see ROADMAP.md)")


def _leaves(data) -> List[Tensor]:
    if isinstance(data, dict):
        return [l for v in data.values() for l in _leaves(v)]
    if isinstance(data, (tuple, list)):
        return [l for v in data for l in _leaves(v)]
    return [data]


def _map(fn: Callable[[Tensor], Tensor], data):
    if isinstance(data, dict):
        return {k: _map(fn, v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_map(fn, v) for v in data)
    return fn(data)


def _num_samples(data) -> int:
    leaves = _leaves(data)
    if not leaves:
        raise ValueError("data has no tensor leaves")
    sizes = {leaf.shape[0] for leaf in leaves}
    if len(sizes) != 1:
        raise ValueError("all data leaves must share the leading (sample) "
                         f"axis; got sizes {sorted(sizes)}")
    return sizes.pop()


def _take(data, idx: Tensor):
    return _map(lambda a: a[idx.to(a.device)], data)


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """``step(model, batch, generator) -> (loss, metrics)``: forward,
    backward and one optimizer step (the optimizer holds the model's
    parameters).  Loss and metrics come back detached, on the device."""

    def step(model, batch, generator):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(model, batch, generator)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                               for k, v in metrics.items()}

    return step


def fit(model: torch.nn.Module, loss_fn: Callable, data: Any, *,
        generator: torch.Generator,
        num_epochs: int = 1,
        batch_size: Optional[int] = None,
        optimizer: Optional[Callable] = None,
        learning_rate: float = 1e-3,
        shuffle: bool = True,
        scan_epochs: bool = False,
        mesh=None,
        process_local_data: bool = False,
        validation_data: Any = None,
        early_stopping_patience: Optional[int] = None,
        min_delta: float = 0.0,
        restore_best: bool = False,
        ema_decay: Optional[float] = None,
        verbose: bool = False) -> Tuple[torch.nn.Module, Dict[str, list]]:
    """Fit ``model`` by minimizing ``loss_fn`` over ``data``; returns
    ``(model, history)``, where history maps metric names (always "loss"
    and "epoch_time_s") to per-epoch means.

    ``generator`` drives the shuffles and every draw the loss makes; it
    lives on the model's device.  ``optimizer`` is a factory
    ``params -> torch.optim.Optimizer`` (``OptimizerConfig.build()``),
    by default Adam at ``learning_rate``.  ``batch_size`` is clamped to
    the sample count; the remainder of each epoch is dropped.  Losses
    stay on the device during an epoch: one host sync per epoch.

    ``scan_epochs=True`` runs this same loop.  In the JAX package it
    compiles each epoch to one program and leaves the streams unchanged,
    so both settings train alike here and there.

    ``validation_data`` (same structure) is evaluated after every epoch,
    without gradients and with one fixed evaluation generator, into
    ``history["val_loss"]``: the monitored quantity of
    ``early_stopping_patience`` (stop after that many epochs without an
    improvement above ``min_delta``; the training loss is monitored
    without a validation set) and of ``restore_best`` (return the best
    epoch's weights).  ``ema_decay``: the returned model carries the
    exponential moving average ``ema <- d ema + (1 - d) params`` taken
    after every step from the initial weights (a copy of ``model``);
    validation monitors the raw weights.

    A callable ``data(generator)`` is a stream: each epoch iterates
    over the batches it returns (``batch_size`` and ``shuffle`` are then
    its own concern).  ``mesh`` and ``process_local_data`` raise
    ``NotImplementedError``.
    """
    if mesh is not None:
        raise _not_ported("fit(mesh=...), sharded training")
    if process_local_data:
        raise _not_ported("fit(process_local_data=True)")
    streamed = callable(data)
    if ema_decay is not None and not (0.0 <= ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in [0, 1); got {ema_decay}")
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = (optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate)))(params)
    step = make_train_step(loss_fn, optimizer)

    if not streamed:
        n = _num_samples(data)
        batch_size = min(batch_size or n, n)
        n_batches = max(n // batch_size, 1)
    device = generator.device

    eval_seed = None
    if validation_data is not None:
        _num_samples(validation_data)
        # One seed, drawn only with a validation set so that training
        # streams are unchanged otherwise; every epoch evaluates with a
        # generator reset to it, so val_loss moves with the model only.
        eval_seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                      device=device))

    ema = copy.deepcopy(model) if ema_decay is not None else None
    if ema is not None:
        ema_params = [e for e, p in zip(ema.parameters(), model.parameters())
                      if p.requires_grad]

    history: Dict[str, list] = {"loss": [], "epoch_time_s": []}
    monitor = "val_loss" if eval_seed is not None else "loss"
    best_monitored = float("inf")
    best_state = None
    epochs_without_improvement = 0
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        losses: List[Tensor] = []
        metrics: Dict[str, List[Tensor]] = {}
        for batch in (data(generator) if streamed
                      else _batches(data, n, batch_size, n_batches, shuffle,
                                    generator)):
            loss, step_metrics = step(model, batch, generator)
            if ema is not None:
                with torch.no_grad():
                    for e, p in zip(ema_params, params):
                        e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
            losses.append(loss)
            for name, v in step_metrics.items():
                if name not in _RESERVED:
                    metrics.setdefault(name, []).append(
                        torch.as_tensor(v, device=loss.device))
        if not losses:
            raise ValueError("data stream yielded no batches")
        means = torch.stack([torch.stack(losses).float().mean()]
                            + [torch.stack(v).float().mean()
                               for v in metrics.values()]).tolist()
        history["loss"].append(means[0])
        history["epoch_time_s"].append(time.perf_counter() - t0)
        for name, v in zip(metrics, means[1:]):
            history.setdefault(name, []).append(v)
        if eval_seed is not None:
            eval_gen = torch.Generator(device=device).manual_seed(eval_seed)
            with torch.no_grad():
                out = loss_fn(model, validation_data, eval_gen)
            history.setdefault("val_loss", []).append(
                float(out[0] if isinstance(out, tuple) else out))
        if verbose:
            val = (f" val_loss {history['val_loss'][-1]:.4f}"
                   if eval_seed is not None else "")
            print(f"epoch {epoch}: loss {history['loss'][-1]:.4f}{val} "
                  f"({history['epoch_time_s'][-1]:.2f}s)")
        monitored = history[monitor][-1]
        if monitored < best_monitored - min_delta:
            best_monitored = monitored
            epochs_without_improvement = 0
            if restore_best:
                best_state = {k: v.detach().clone() for k, v in
                              (model if ema is None else ema
                               ).state_dict().items()}
        else:
            epochs_without_improvement += 1
            if (early_stopping_patience is not None
                    and epochs_without_improvement >= early_stopping_patience):
                break
    if ema is not None:
        model = ema
    if best_state is not None:
        model.load_state_dict(best_state)
    return model, history


def _batches(data, n: int, batch_size: int, n_batches: int, shuffle: bool,
             generator: torch.Generator):
    """One epoch's batches: a permutation drawn from ``generator`` (or
    the identity), cut into ``n_batches`` of ``batch_size``."""
    order = (torch.randperm(n, generator=generator, device=generator.device)
             if shuffle else torch.arange(n, device=generator.device))
    for b in range(n_batches):
        yield _take(data, order[b * batch_size:(b + 1) * batch_size])


def stack_models(models: Sequence[torch.nn.Module]) -> torch.nn.ModuleList:
    """K models of one structure as one ensemble, the input of
    :func:`fit_ensemble` (a ModuleList of the members themselves; the
    JAX package stacks their leaves along a new leading axis)."""
    return torch.nn.ModuleList(models)


def unstack_model(stack: Sequence[torch.nn.Module],
                  i: int) -> torch.nn.Module:
    """Ensemble member ``i``."""
    return stack[i]


def fit_ensemble(model_stack: Sequence[torch.nn.Module], loss_fn: Callable,
                 data: Any, *, generator: torch.Generator,
                 num_epochs: int = 1,
                 batch_size: Optional[int] = None,
                 optimizer: Optional[Callable] = None,
                 learning_rate: float = 1e-3,
                 shuffle: bool = True
                 ) -> Tuple[torch.nn.ModuleList, Dict[str, Any]]:
    """Train the K members of ``model_stack`` (:func:`stack_models`)
    side by side: every member sees the same shuffled batches, each has
    its own optimizer (``optimizer`` is a factory, by default Adam at
    ``learning_rate``) and its own generator, seeded from
    ``generator``.  Returns the stack, trained in place, and a history
    whose "loss" (and every metric) entries are per-epoch ``(K,)``
    arrays.  Each step runs the members one after another."""
    if callable(data):
        raise ValueError(
            "fit_ensemble needs in-memory data (every member takes the "
            "same batches); materialize the stream or use fit() per "
            "member")
    stack = stack_models(list(model_stack))
    device = generator.device
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps,
                                                         lr=learning_rate))
    steps = [make_train_step(loss_fn, make_opt(
        [p for p in m.parameters() if p.requires_grad])) for m in stack]
    seeds = torch.randint(2 ** 62, (len(stack),), generator=generator,
                          device=device).tolist()
    member_gens = [torch.Generator(device=device).manual_seed(s)
                   for s in seeds]
    n = _num_samples(data)
    batch_size = min(batch_size or n, n)
    n_batches = max(n // batch_size, 1)
    history: Dict[str, Any] = {"loss": [], "epoch_time_s": []}
    for _ in range(num_epochs):
        t0 = time.perf_counter()
        losses: List[Tensor] = []
        metrics: Dict[str, List[Tensor]] = {}
        for batch in _batches(data, n, batch_size, n_batches, shuffle,
                              generator):
            outs = [step(m, batch, g)
                    for step, m, g in zip(steps, stack, member_gens)]
            losses.append(torch.stack([o[0] for o in outs]))
            for name in outs[0][1]:
                if name not in _RESERVED:
                    metrics.setdefault(name, []).append(torch.stack([
                        torch.as_tensor(o[1][name], device=device)
                        for o in outs]))
        history["loss"].append(
            torch.stack(losses).float().mean(0).cpu().numpy())
        history["epoch_time_s"].append(time.perf_counter() - t0)
        for name, v in metrics.items():
            history.setdefault(name, []).append(
                torch.stack(v).float().mean(0).cpu().numpy())
    return stack, history
