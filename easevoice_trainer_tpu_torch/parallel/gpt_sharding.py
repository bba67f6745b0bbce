"""Tensor parallelism of the s1 GPT over the grid's model group (JAX:
parallel/gpt_sharding.py).

Megatron-style, over the n_model ranks of one model group (rank m holds
shard m):

* column-parallel (``colp``): the fused qkv projection
  ``self_attn.in_proj_weight`` (3D, D) and ``linear1.weight`` (F, D) keep
  1/n_model of their output rows, with their biases (``colb``);
* row-parallel (``rowp``): ``self_attn.out_proj.weight`` (D, D) and
  ``linear2.weight`` (D, F) keep 1/n_model of their input columns; their
  biases are replicated and added once, after the sum;
* everything else (embeddings, norms, positions, ``bert_proj``, the head)
  is replicated (``rep``).

The fused qkv rows are [q | k | v], each H heads of dk: shard m is
[q_m | k_m | v_m], the rows of its own heads H/n_model * m .. in each of the
three, so a rank's attention runs on whole heads.  (JAX's ``P(None,
"model")`` on its (D, 3D) kernel is a contiguous third, which XLA reshards;
the port never holds that split.)

Two autograd functions carry the layer across the group (Megatron's f and
g): :func:`copy_to_model` before ``qkv`` and ``linear1`` (identity forward,
the input's gradient summed over the group backward) and
:func:`reduce_from_model` after ``out_proj`` and ``linear2`` (the partial
products summed forward, identity backward).  ``torch.distributed.nn``'s
``all_reduce`` is not g: its backward sums the gradient again, which would
multiply every gradient upstream by n_model.

A layer is 2 all-reduces of (B, T, D) forward and 2 backward.  Everything
else in the step is replicated on the ranks of a model group and computed
alike on each, so their replicated parameters stay bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import distributed

SHARD_CLASSES = ("colp", "rowp", "colb", "rep")


def shard_class(name: str) -> str:
    """The shard class of a GPT state-dict name (the port's torch names)."""
    if name.endswith(("self_attn.in_proj_weight", "linear1.weight")):
        return "colp"
    if name.endswith(("self_attn.out_proj.weight", "linear2.weight")):
        return "rowp"
    if name.endswith(("self_attn.in_proj_bias", "linear1.bias")):
        return "colb"
    return "rep"


def _layout(name: str):
    """(split axis, parts) of a sharded tensor: parts 3 for the fused qkv
    rows, whose q, k and v are each split; None for a replicated one."""
    cls = shard_class(name)
    if cls == "rep":
        return None
    return (1 if cls == "rowp" else 0,
            3 if "in_proj" in name.rsplit(".", 1)[-1] else 1)


def shard_tensor(name: str, whole: torch.Tensor, m: int,
                 n_model: int) -> torch.Tensor:
    """Shard ``m`` of ``n_model`` of the whole tensor ``name`` (a parameter
    or an optimizer state of its shape); a replicated one as it is."""
    layout = _layout(name)
    if layout is None or n_model == 1:
        return whole
    axis, parts = layout
    if whole.shape[axis] % (parts * n_model):
        raise ValueError(f"shard_tensor: {name} {tuple(whole.shape)} does "
                         f"not split in {n_model} along axis {axis}")
    return torch.cat([part.chunk(n_model, axis)[m]
                      for part in whole.chunk(parts, axis)], axis)


def gather_tensor(name: str, shards: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """The whole tensor ``name`` from its ``shards`` in model order (the
    inverse of :func:`shard_tensor`)."""
    layout = _layout(name)
    if layout is None or len(shards) == 1:
        return shards[0]
    axis, parts = layout
    pieces = [s.chunk(parts, axis) for s in shards]
    return torch.cat([p[i] for i in range(parts) for p in pieces], axis)


def shard_state_dict(whole: Dict[str, torch.Tensor], m: int, n_model: int
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``m``'s state dict of a whole GPT state dict (copies)."""
    return {k: shard_tensor(k, v, m, n_model).clone()
            for k, v in whole.items()}


def gather_state_dicts(shards: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The whole state dict of the model group's ``shards`` (model
    order)."""
    return {k: gather_tensor(k, [s[k] for s in shards]) for k in shards[0]}


def gather_whole(named: Sequence[Tuple[str, torch.Tensor]]
                 ) -> List[torch.Tensor]:
    """The whole tensors of this rank's ``(name, shard)`` pairs, gathered
    over the model group (a collective: every rank of the group calls it
    with the same names); replicated ones as they are."""
    return [t if shard_class(k) == "rep" else
            gather_tensor(k, distributed.gather_model(t)) for k, t in named]


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """Which parameters of one optimizer are shards of whole tensors (in
    parameter order), and n_model: what ScaledAdam needs to take its
    per-tensor sums over whole tensors (``train/scaled_adam.py``), summed
    over the model group by ``distributed.all_reduce_model``."""

    sharded: Tuple[bool, ...]
    n_model: int


def model_shards(model: torch.nn.Module) -> Optional[ModelShards]:
    """The :class:`ModelShards` of a GPT built for a model index (None for
    a whole one)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return None
    return ModelShards(tuple(shard_class(k) != "rep"
                             for k, _ in model.named_parameters()), tp[1])


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; backward, the gradient summed over
    the model group (each rank's column-parallel product gave a part)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_model(grad.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: forward, the partial products summed over the model
    group; backward, identity (each rank's part had the whole output's
    gradient)."""

    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_model(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f, before a column-parallel product."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g, after a row-parallel product."""
    return _ReduceFromModel.apply(x)


def row_parallel_linear(lin: torch.nn.Linear, x: torch.Tensor,
                        dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A row-parallel ``nn.Linear`` (weight (out, in / n_model), whole
    bias) of this rank's input columns ``x``: the partial products summed
    over the model group (:func:`reduce_from_model`), then the bias, once.
    In bf16 (``dtype``) the partial products of the bf16 input and weight
    are taken and summed in fp32 and rounded to bf16 once, before the bf16
    bias add: the rounding points of ``nn.layers.linear_in`` on the whole
    layer."""
    if dtype is None:
        return reduce_from_model(F.linear(x, lin.weight)) + lin.bias
    part = F.linear(x.to(dtype).float(), lin.weight.to(dtype).float())
    return reduce_from_model(part).to(dtype) + lin.bias.to(dtype)
