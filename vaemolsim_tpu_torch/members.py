"""The member axis: K models of one structure held and run as one
(port of the JAX package's leaf-stacked ensembles,
``vaemolsim_tpu/train/loop.py`` ``stack_models`` / ``unstack_model``, and
of the ``vmap`` over them in ``fit_ensemble`` and ``nn/uq.py``).

A :class:`ModelStack` holds every parameter and buffer of its members
once, stacked along a leading member axis.  The members stay modules:
``stack[i]`` is member i, whose parameters and buffers are views of
slice i of the stacked tensors, so one optimizer over
``stack.parameters()`` updates every member, and a member's own update
is the stack's.

:meth:`ModelStack.vmap` evaluates ``fn(member, *args)`` for all members
as one ``torch.func.vmap`` over the stacked tensors.  ``fn`` runs whole
inside ``torch.func.functional_call``: a value built lazily from the
member (a flow's distribution, whose transform runs when its
``log_prob`` is called) must be evaluated inside ``fn``, where the
member's slice is in place.  It cannot leak out: ``vmap`` returns
tensors only.  Kernel routes under the transform launch once for all
members (``_build.call_with_plain_grad``'s ``member_fn``); a kernel
without a member axis raises on the card.

On the CPU the transform takes the members one at a time (``vmap``'s
``chunk_size=1``): PyTorch's CPU kernels compute the tail of a vector
loop with other instructions (libm's ``exp`` against a vectorised one in
``sigmoid``, ``silu``, ``softplus`` and their gradients) than its body,
so members sharing one batched tensor would round differently by their
position in it, and identical members would disagree.  On the card
every element takes the same instructions, and the K members run as one
batched program.
"""

from __future__ import annotations

import copy
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

Tensor = torch.Tensor

__all__ = ["ModelStack", "stack_models", "unstack_model", "member_chunk",
           "call_member", "vmap_members", "stacked_state"]

# The stack each member belongs to, weakly (a member of a live stack,
# stacked again, is copied, so that the first stack keeps its views).
_OWNER: "weakref.WeakKeyDictionary[nn.Module, weakref.ref]" = (
    weakref.WeakKeyDictionary())


def member_chunk(device: torch.device) -> Optional[int]:
    """``torch.func.vmap``'s ``chunk_size`` over a member axis on
    ``device``: 1 on the CPU (see the module's note), all at once
    elsewhere."""
    return 1 if device.type == "cpu" else None


def _set(module: nn.Module, name: str, value: Tensor) -> None:
    """Parameter or buffer ``name`` (dotted) of ``module`` replaced."""
    path, _, leaf = name.rpartition(".")
    owner = module.get_submodule(path)
    if isinstance(value, nn.Parameter):
        owner._parameters[leaf] = value
    else:
        owner._buffers[leaf] = value


class _Call(nn.Module):
    """``fn(member, *args)`` as a module's forward, so that
    ``functional_call`` keeps the member's slice in place for all of
    ``fn``."""

    def __init__(self, member: nn.Module, fn: Callable):
        super().__init__()
        self.member = member
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.member, *args)


class ModelStack(nn.ModuleList):
    """K models of one structure as one ensemble (:func:`stack_models`).

    ``len``, iteration and indexing go over the members (a
    ``ModuleList``'s interface); ``parameters()``, ``state_dict()`` and
    ``.to()`` over the stacked tensors, which live in ``stacked``, a
    module of the members' structure whose parameters and buffers are
    (K, ...) tensors.  The members are not submodules.  Moving the stack
    (``.to``, ``.cuda``) re-points the members at the moved tensors.
    """

    def __init__(self, members: Sequence[nn.Module]):
        nn.Module.__init__(self)
        own, seen = [], set()
        for m in members:
            owner = _OWNER.get(m)
            if id(m) in seen or (owner is not None and owner() is not None):
                m = copy.deepcopy(m)
            seen.add(id(m))
            own.append(m)
        if not own:
            raise ValueError("stack_models: no members")
        template = own[0]
        names = [n for n, _ in template.named_parameters()]
        if len(names) != len(list(template.named_parameters(
                remove_duplicate=False))):
            raise ValueError("stack_models: members with tied parameters "
                             "are not supported")
        self.__dict__["_members"] = own
        stacked = copy.deepcopy(template)
        for name, p in template.named_parameters():
            _set(stacked, name, nn.Parameter(
                torch.stack([m.get_parameter(name).detach() for m in own]),
                requires_grad=p.requires_grad))
        for name, _ in template.named_buffers():
            _set(stacked, name,
                 torch.stack([m.get_buffer(name) for m in own]))
        self.stacked = stacked
        self._alias()

    def _alias(self) -> None:
        """Every member's parameters and buffers made views of its slice
        of the stacked tensors."""
        params = list(self.stacked.named_parameters())
        buffers = list(self.stacked.named_buffers())
        for i, m in enumerate(self._members):
            for name, p in params:
                _set(m, name, nn.Parameter(p.detach()[i],
                                           requires_grad=p.requires_grad))
            for name, b in buffers:
                _set(m, name, b[i])
            _OWNER[m] = weakref.ref(self)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._alias()
        return self

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self._members:
            m.train(mode)
        return self

    def __deepcopy__(self, memo):
        return type(self)([copy.deepcopy(m, memo) for m in self._members])

    def __len__(self) -> int:
        return len(self._members)

    def __iter__(self):
        return iter(self._members)

    def __getitem__(self, idx):
        return self._members[idx]

    def _fixed(self, *args, **kwargs):
        raise TypeError("a ModelStack's members are fixed: stack_models "
                        "anew")

    append = extend = insert = __setitem__ = __delitem__ = _fixed
    __iadd__ = __add__ = pop = _fixed

    def __repr__(self) -> str:
        return (f"ModelStack({len(self)} x "
                f"{type(self._members[0]).__name__})")

    def state(self, graph: bool = False) -> Dict[str, Tensor]:
        """Every stacked parameter and buffer by its member name, (K, ...)
        each: detached views of the stack's own storage, or with
        ``graph`` the stacked parameters themselves (an outer autograd
        then reaches them)."""
        out = {n: p if graph else p.detach()
               for n, p in self.stacked.named_parameters()}
        out.update(self.stacked.named_buffers())
        return out

    def call(self, fn: Callable, state: Dict[str, Tensor], *args):
        """``fn(member, *args)`` with the member's parameters and buffers
        taken from ``state`` (one member's slice of :meth:`state`, or the
        slices a transform passes), all of ``fn`` inside the call."""
        return call_member(self.stacked, fn, state, *args)

    def vmap(self, fn: Callable, *args) -> Any:
        """``fn(member, *args)`` for every member at once, the arguments
        shared: one ``torch.func.vmap`` of :meth:`call` over the stacked
        tensors.  Outputs (tensors, or tuples / dicts of them) come back
        with a leading member axis; under grad mode they keep their graph
        to the stacked parameters."""
        return vmap_members(self.stacked,
                            self.state(graph=torch.is_grad_enabled()), fn,
                            *args)


def call_member(template: nn.Module, fn: Callable,
                state: Dict[str, Tensor], *args):
    """``fn(member, *args)``, the member ``template`` (a module of the
    members' structure) with its parameters and buffers taken from
    ``state``, all of ``fn`` inside ``torch.func.functional_call``."""
    return torch.func.functional_call(
        _Call(template, fn), {f"member.{k}": v for k, v in state.items()},
        args, strict=True)


def vmap_members(template: nn.Module, state: Dict[str, Tensor],
                 fn: Callable, *args) -> Any:
    """``fn(member, *args)`` for every member of a stacked ``state``
    ((K, ...) tensors by member name), the arguments shared: one
    ``torch.func.vmap`` of :func:`call_member`."""
    return torch.func.vmap(
        lambda st, *a: call_member(template, fn, st, *a),
        in_dims=(0,) + (None,) * len(args), randomness="error",
        chunk_size=member_chunk(next(iter(state.values())).device))(
            state, *args)


def stacked_state(members: Sequence[nn.Module]) -> Dict[str, Tensor]:
    """The parameters and buffers of ``members`` (modules of one
    structure) stacked on a new leading member axis, the members left as
    they are: each stacked parameter keeps its graph, so an outer
    autograd reaches every member's own parameters (the input of
    :func:`vmap_members` for a committee given as a sequence)."""
    first = members[0]
    out = {n: torch.stack([m.get_parameter(n) for m in members])
           for n, _ in first.named_parameters()}
    out.update({n: torch.stack([m.get_buffer(n) for m in members])
                for n, _ in first.named_buffers()})
    return out


def stack_models(models: Sequence[nn.Module]) -> ModelStack:
    """K models of one structure as one :class:`ModelStack`: each
    parameter and buffer stacked once along a new leading member axis,
    the input of ``train.fit_ensemble`` and of the committees of
    ``nn.uq``.  Member i stays ``models[i]`` itself, its tensors now
    views of the stack's; a module given twice, or already a member of
    another stack, is copied first."""
    return ModelStack(models)


def unstack_model(stack: ModelStack, i: int) -> nn.Module:
    """Ensemble member ``i``: a module whose parameters and buffers are
    views of slice i of the stack's."""
    return stack[i]
