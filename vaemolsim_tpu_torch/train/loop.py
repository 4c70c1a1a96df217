"""Training loop over ``nn.Module`` models (port of
``vaemolsim_tpu/train/loop.py``).

The loss is a callable ``loss_fn(model, batch, generator) -> scalar |
(scalar, metrics)``; one step is forward, ``loss.backward()`` and
``optimizer.step()``, updating the model in place.  Batching drops the
remainder, so every batch has the same shape.  ``data`` is a tensor or
a tuple / list / dict of tensors sharing the leading (sample) axis.

``data`` may instead be a callable ``data(generator) -> iterable of
batches``, a stream drawn anew each epoch.  ``fit_ensemble`` trains K
models of one structure (a :class:`~vaemolsim_tpu_torch.members.
ModelStack`) on the same batches as one program: one ``torch.func.vmap``
of the members' gradients over the stacked tensors and one optimizer
over them, as the JAX package ``vmap``s its step.  ``fit(mesh=...)`` trains
data-parallel over a ``DeviceMesh`` dimension: each rank takes its slice
of every batch and the gradients are all-reduced after ``backward``.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch._tree import leaves, tree_map
from vaemolsim_tpu_torch.members import (ModelStack, member_chunk,
                                         stack_models, unstack_model)
from vaemolsim_tpu_torch.parallel.distributed import (all_gather_cat,
                                                      mesh_dim,
                                                      rank_generator)
from vaemolsim_tpu_torch.parallel.sharding import replicate

Tensor = torch.Tensor

__all__ = ["fit", "fit_ensemble", "make_train_step", "stack_models",
           "unstack_model", "ModelStack", "EnsembleAdam"]

# History keys that a loss's metrics may not overwrite (elbo_loss's own
# "loss" metric duplicates the total).
_RESERVED = ("loss", "epoch_time_s")


def _num_samples(data) -> int:
    found = leaves(data)
    if not found:
        raise ValueError("data has no tensor leaves")
    sizes = {leaf.shape[0] for leaf in found}
    if len(sizes) != 1:
        raise ValueError("all data leaves must share the leading (sample) "
                         f"axis; got sizes {sorted(sizes)}")
    return sizes.pop()


def _take(data, idx: Tensor):
    return tree_map(lambda a: a[idx.to(a.device)], data)


def _average_grads(params: List[Tensor], group, world: int) -> None:
    """Each parameter's gradient replaced by its mean over ``group``'s
    ranks: one all-reduce of the flattened gradients (a missing gradient
    counts as zeros, so every rank sends the same layout)."""
    import torch.distributed as dist

    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(p).clone()
        offset += g.numel()


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    grad_group=None, world: int = 1) -> Callable:
    """``step(model, batch, generator) -> (loss, metrics)``: forward,
    backward and one optimizer step (the optimizer holds the model's
    parameters).  Loss and metrics come back detached, on the device.
    With ``grad_group`` (a process group of ``world`` ranks) the
    gradients are averaged over its ranks before the optimizer step."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(model, batch, generator):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(model, batch, generator)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        if grad_group is not None:
            _average_grads(params, grad_group, world)
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
        mesh_axis: str = "batch",
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
    its own concern).

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) for data-parallel
    training over its dimension ``mesh_axis``.  Every rank calls ``fit``
    with the same model, data, generator seed and settings; the model is
    made equal to rank 0's, every rank draws the same shuffle and takes
    its slice of each batch, the loss's own draws come from a stream of
    the rank's own, and the gradients are averaged over the ranks (one
    all-reduce a step) before the optimizer step, so the ranks' weights
    stay identical.  ``batch_size`` must divide over the dimension, and
    the sample count is trimmed to a multiple of it.  Results match the
    one-device ``fit`` up to float reduction order (for a loss that
    draws nothing).  The history is the mean over the ranks; a
    validation set is trimmed alike and evaluated whole on every rank,
    which all get the same value.

    ``process_local_data=True``: every rank passes only its shard of the
    data; the shards are all-gathered once, in rank order, into the
    global set (at the sizes this library trains on, a copy on every
    rank is cheap), which then trains as above.  It takes a ``mesh``,
    ``scan_epochs=True`` (the JAX package's requirement, kept), no
    stream and no validation set, and a global sample count that
    divides over the dimension.
    """
    streamed = callable(data)
    if process_local_data:
        if validation_data is not None:
            raise ValueError(
                "validation_data is not supported with process_local_data "
                "(each rank holds only its shard); evaluate after training")
        if mesh is None:
            raise ValueError("process_local_data needs a process-spanning "
                             "mesh (parallel.make_mesh after "
                             "initialize_distributed)")
        if streamed:
            raise ValueError("process_local_data takes in-memory local "
                             "shards; wrap streams per-process upstream")
        if not scan_epochs:
            raise ValueError(
                "multi-process fit requires scan_epochs=True (the JAX "
                "package's rule, kept so that one call runs in both)")
    if ema_decay is not None and not (0.0 <= ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in [0, 1); got {ema_decay}")
    group, world, rank = None, 1, 0
    if mesh is not None:
        group, world, rank = mesh_dim(mesh, mesh_axis)
        if process_local_data:
            data = _gather_shards(data, group)
        replicate(model, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = (optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate)))(params)
    step = make_train_step(loss_fn, optimizer, group, world)

    if not streamed:
        n = _num_samples(data)
        batch_size = min(batch_size or n, n)
        n_batches = max(n // batch_size, 1)
        if mesh is not None:
            if batch_size % world:
                raise ValueError(
                    f"batch_size ({batch_size}) must divide evenly over "
                    f"the {world}-way {mesh_axis!r} mesh axis")
            n_keep = n - n % world
            if n_keep != n:
                if process_local_data:
                    raise ValueError(
                        f"global sample count ({n}) must divide evenly "
                        f"over the {world}-way {mesh_axis!r} axis in "
                        "multi-process mode (pad or trim the shards)")
                data = tree_map(lambda a: a[:n_keep], data)
                n = n_keep
                batch_size = min(batch_size, n)
                n_batches = max(n // batch_size, 1)
    device = generator.device
    # Under a mesh the loss draws from this rank's own stream (the same
    # draws on every rank would correlate the ranks' samples); the
    # shuffles and the evaluation seed stay on the shared generator.
    loss_gen = (generator if mesh is None
                else rank_generator(generator, rank))

    eval_seed = None
    if validation_data is not None:
        nv = _num_samples(validation_data)
        if mesh is not None:
            nv_keep = nv - nv % world
            if nv_keep == 0:
                raise ValueError(
                    f"validation_data has {nv} samples, fewer than the "
                    f"{world}-way {mesh_axis!r} mesh axis (an empty "
                    "trimmed set would make val_loss NaN)")
            validation_data = tree_map(lambda a: a[:nv_keep], validation_data)
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
                                    generator, rank, world)):
            loss, step_metrics = step(model, batch, loss_gen)
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
                               for v in metrics.values()])
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(means, group=group)
            means = means / world
        means = means.tolist()
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
             generator: torch.Generator, rank: int = 0, world: int = 1):
    """One epoch's batches: a permutation drawn from ``generator`` (or
    the identity), cut into ``n_batches`` of ``batch_size``; with
    ``world`` ranks, slice ``rank`` of each batch."""
    order = (torch.randperm(n, generator=generator, device=generator.device)
             if shuffle else torch.arange(n, device=generator.device))
    share = batch_size // world
    for b in range(n_batches):
        lo = b * batch_size + rank * share
        yield _take(data, order[lo:lo + share])


def _gather_shards(data, group):
    """The global data set from each rank's shard: an all-gather of every
    leaf over ``group``, concatenated in rank order (shards may differ
    in length).  One gather of the whole set, once a fit: fine at the
    sizes a single host's memory holds."""
    sizes = all_gather_cat(torch.tensor([_num_samples(data)]),
                           group).tolist()
    top = max(sizes)

    def gather(a):
        a = torch.as_tensor(a)
        pad = a.new_zeros((top - a.shape[0],) + tuple(a.shape[1:]))
        parts = all_gather_cat(torch.cat([a, pad]), group).split(top)
        return torch.cat([p[:k] for p, k in zip(parts, sizes)])

    return tree_map(gather, data)


def _member_grads(stack: ModelStack, loss_fn: Callable) -> Callable:
    """``grads(trained, fixed, *args, in_dims) -> (grads, aux)``: the
    gradient in the ``trained`` stacked tensors of every member's loss as
    one ``torch.func.vmap`` of ``torch.func.grad`` over the stack's member
    axis, the member's ``fixed`` tensors (frozen parameters, buffers)
    held.  ``loss_fn(member, *args) -> (loss, aux)`` runs whole inside
    the member's functional call (:meth:`ModelStack.call`); ``aux`` comes
    back stacked.  ``in_dims`` gives each argument's member axis (None:
    shared).  Randomness inside the vmapped call raises."""
    def member_loss(trained, fixed, *args):
        return stack.call(loss_fn, {**trained, **fixed}, *args)

    grad = torch.func.grad(member_loss, has_aux=True)

    def grads(trained, fixed, *args, in_dims):
        return torch.func.vmap(
            grad, in_dims=(0, 0, *in_dims), randomness="error",
            chunk_size=member_chunk(next(iter(trained.values())).device))(
                trained, fixed, *args)

    return grads


def _ensemble_step(stack: ModelStack, loss_fn: Callable,
                   optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch, draws) -> ((K,) losses, {name: (K,) metric})``: the
    gradient of every member's loss as one ``torch.func.vmap`` of
    ``torch.func.grad`` over the stack's member axis, then one step of
    ``optimizer``, which holds the stack's trainable stacked tensors
    (Adam is elementwise, so this is K per-member Adams).

    ``loss_fn(member, batch, draws)`` runs whole inside the member's
    functional call (:meth:`ModelStack.call`), ``batch`` shared by all
    members, ``draws`` each member's slice of the stacked draws (or
    None).  It may not draw from a generator: randomness inside the
    vmapped call raises."""
    params = dict(stack.stacked.named_parameters())
    train = [n for n, p in params.items() if p.requires_grad]

    def with_metrics(member, batch, draws):
        out = loss_fn(member, batch, draws)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        metrics = {k: torch.as_tensor(v) for k, v in metrics.items()
                   if k not in _RESERVED}
        return loss, (loss, metrics)

    member_grads = _member_grads(stack, with_metrics)

    def step(batch, draws=None):
        state = stack.state()
        trained = {n: state.pop(n) for n in train}
        grads, (loss, metrics) = member_grads(
            trained, state, batch, draws,
            in_dims=(None, None if draws is None else 0))
        for n in train:
            params[n].grad = grads[n]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), metrics

    return step


def fit_ensemble(model_stack: Sequence[torch.nn.Module], loss_fn: Callable,
                 data: Any, *, generator: torch.Generator,
                 num_epochs: int = 1,
                 batch_size: Optional[int] = None,
                 optimizer: Optional[Callable] = None,
                 learning_rate: float = 1e-3,
                 shuffle: bool = True,
                 draw: Optional[Callable] = None
                 ) -> Tuple[ModelStack, Dict[str, Any]]:
    """Train the K members of ``model_stack`` (a :class:`ModelStack`, or
    the members, stacked here) as one program: every member sees the
    same shuffled batches, and each step is one vmapped gradient over
    the member axis and one optimizer over the stacked tensors
    (``optimizer`` is a factory, by default Adam at ``learning_rate``)
    (:func:`_ensemble_step`).  Each member has its own generator,
    seeded from ``generator``; ``draw(member generator)``, where given,
    makes a member's random inputs for a step outside the vmapped call,
    and ``loss_fn(member, batch, draws)`` gets them as its third
    argument (None without ``draw``).  Returns the stack, trained in
    place, and a history whose "loss" (and every metric) entries are
    per-epoch ``(K,)`` arrays."""
    if callable(data):
        raise ValueError(
            "fit_ensemble needs in-memory data (every member takes the "
            "same batches); materialize the stream or use fit() per "
            "member")
    stack = (model_stack if isinstance(model_stack, ModelStack)
             else stack_models(list(model_stack)))
    device = generator.device
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps,
                                                         lr=learning_rate))
    step = _ensemble_step(stack, loss_fn, make_opt(
        [p for p in stack.parameters() if p.requires_grad]))
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
            draws = (None if draw is None else
                     _stack_trees([draw(g) for g in member_gens]))
            loss, got = step(batch, draws)
            losses.append(loss)
            for name, v in got.items():
                metrics.setdefault(name, []).append(v)
        history["loss"].append(
            torch.stack(losses).float().mean(0).cpu().numpy())
        history["epoch_time_s"].append(time.perf_counter() - t0)
        for name, v in metrics.items():
            history.setdefault(name, []).append(
                torch.stack(v).float().mean(0).cpu().numpy())
    return stack, history


def _stack_trees(trees: Sequence[Any]) -> Any:
    """Same-structured trees of tensors stacked leaf by leaf on a new
    leading (member) axis."""
    first = trees[0]
    if isinstance(first, Tensor):
        return torch.stack(list(trees))
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return type(first)(_stack_trees(list(c)) for c in zip(*trees))


class EnsembleAdam:
    """Adam over a :class:`ModelStack`'s member axis as a function of a
    state of tensors: the form of a training loop replayed by
    ``utils.scan.scan_collect`` (the JAX examples' ``lax.scan`` over a
    vmapped ``optax.adam`` step, whose update this writes out: optax's
    moments, bias corrections and order of operations, the step count a
    device tensor, so a captured step reads nothing from the host).

    :meth:`init` gives the state (copies of the stack's trainable stacked
    parameters, the two moments, the count); :meth:`update` takes one
    step for every member, the gradients of ``loss_fn(member, *args)``
    as one ``torch.func.vmap`` of ``torch.func.grad`` over the member
    axis; :meth:`write` copies a state's parameters into the stack (and
    so into its members).  Frozen parameters and buffers are read from
    the stack."""

    def __init__(self, stack: ModelStack, loss_fn: Callable, *,
                 learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.stack = stack
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.names = [n for n, p in stack.stacked.named_parameters()
                      if p.requires_grad]

        def with_loss(member, *args):
            loss = loss_fn(member, *args)
            return loss, loss

        self._grads = _member_grads(stack, with_loss)

    def init(self) -> Dict[str, Any]:
        state = self.stack.state()
        params = {n: state[n].clone() for n in self.names}
        device = next(iter(params.values())).device
        return {"params": params,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()},
                "count": torch.zeros((), device=device)}

    def update(self, state: Dict[str, Any], *args,
               in_dims: Optional[Sequence[Optional[int]]] = None
               ) -> Tuple[Dict[str, Any], Tensor]:
        """One step: ``(new state, (K,) losses)``.  ``in_dims`` gives
        each argument's member axis (None: shared, the default)."""
        fixed = {n: t for n, t in self.stack.state().items()
                 if n not in state["params"]}
        dims = tuple(in_dims) if in_dims is not None else (None,) * len(args)
        params = state["params"]
        grads, loss = self._grads(params, fixed, *args, in_dims=dims)
        count = state["count"] + 1
        c1 = 1 - self.b1 ** count
        c2 = 1 - self.b2 ** count
        new = {"params": {}, "mu": {}, "nu": {}, "count": count}
        for n, p in params.items():
            g = grads[n]
            mu = (1 - self.b1) * g + self.b1 * state["mu"][n]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][n]
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            new["params"][n] = p + step * -self.lr
            new["mu"][n], new["nu"][n] = mu, nu
        return new, loss

    def write(self, state: Dict[str, Any]) -> None:
        params = dict(self.stack.stacked.named_parameters())
        with torch.no_grad():
            for n, t in state["params"].items():
                params[n].copy_(t)
