"""s1 GPT training step with gradient accumulation (JAX: train/gpt_step.py
``GPTTrainHP`` and ``make_train_step``).

* CE-sum loss and top-3 accuracy from ``Text2SemanticDecoder.forward``
  (or the DPO objective of ``models/gpt/dpo.py`` when ``if_dpo``);
* ScaledAdam at a learning rate locked at 0.002, betas (0.9, 0.95),
  clipping_scale 2 (the reference's WarmupCosineLRSchedule locks itself to
  that constant, and so does the JAX package by default; the learning-rate
  keys of configs/gpt.yaml's "optimizer" section have no effect there and
  are not read here);
* accumulation as ``optax.MultiSteps(every_k_schedule=grad_accum)`` does
  it: the optimizer sees the running mean of the micro-batch gradients
  (``acc + (g - acc) / (n + 1)``) and steps on every ``grad_accum``-th
  call, so its count, clip ring and size period advance once per
  ``grad_accum`` micro-batches while :attr:`GPTTrainStep.step` counts every
  micro-batch.

Metrics are 0-d tensors on the model's device: ``loss``, ``acc`` and
``grad_norm``, the global norm of the micro-batch's raw gradients.

Data parallel (``parallel/``): a rank passes ``rows``, where its rows sit
in the global micro-batch.  Its loss is its share of the global batch's:
the CE is a sum over every position (JAX t2s.py:294), so the ranks' shares
add up to it as they are, and DPO's means over rows are scaled by local /
global rows (``models/gpt/dpo.py``).  The gradients are summed over the
world (``reduce_gradients``, one all-reduce) right after the backward,
before ``grad_norm``, the running mean and ScaledAdam, so every rank holds
the global micro-batch's gradient and takes the same optimizer step.  The
accuracy is the ranks' hits over the world's count of targets, and the
loss is summed over the world (``sum_across_ranks``): every rank reports
the global batch's metrics, as JAX does.

Tensor parallelism (a model built with ``tp``, ``parallel/gpt_sharding.py``):
the ranks of a model group hold one data index's rows and their shards of
the model, and compute its whole loss and replicated gradients alike.  The
gradients are summed over the data group, the metrics too, and
``grad_norm`` is the whole tensors' norm: the sharded tensors' sum(g^2)
summed over the model group, the replicated ones' counted once.  ScaledAdam
takes its per-tensor sums over whole tensors
(``gpt_sharding.ModelShards``).  :meth:`GPTTrainStep.state_dict` holds
whole tensors, gathered over the model group, and
:meth:`GPTTrainStep.load_state_dict` takes whole tensors and keeps the
rank's shards, so resume files do not depend on the grid.

The forward runs in the model's compute dtype (bf16 under ``is_half``, JAX
``train/gpt.py:162-163``); the loss and accuracy come from fp32 logits, and
the gradients of the fp32 parameters reach the accumulator and ScaledAdam
in fp32, as with an fp32 model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..models.gpt import Text2SemanticDecoder
from ..nn.layers import BatchRows
from ..parallel import distributed, gpt_sharding
from .scaled_adam import ScaledAdam


LOCKED_LR = 0.002
BETAS = (0.9, 0.95)
CLIPPING_SCALE = 2.0


@dataclasses.dataclass(frozen=True)
class GPTTrainHP:
    grad_accum: int = 4
    if_dpo: bool = False


OPTIMIZER_RANGE = "ScaledAdam.step"
# ScaledAdam's per-element state, sharded as its parameter is
SHARDED_STATE = ("exp_avg_sq", "delta")


class GPTTrainStep:
    """One micro-batch of the s1 fine-tune: forward, backward, accumulate,
    and an optimizer step on every ``hp.grad_accum``-th call."""

    def __init__(self, model: Text2SemanticDecoder, hp: GPTTrainHP):
        self.model = model
        self.hp = hp
        named = list(model.named_parameters())
        self.names = [k for k, _ in named]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.shards = gpt_sharding.model_shards(model)
        self.optimizer = ScaledAdam(self.params, lr=LOCKED_LR, betas=BETAS,
                                    clipping_scale=CLIPPING_SCALE,
                                    shards=self.shards)
        self.step = 0          # micro-batches taken
        self.mini_step = 0     # position inside the accumulation window
        self.acc: Optional[List[torch.Tensor]] = None

    def loss(self, batch: Dict[str, torch.Tensor],
             seed: Optional[int] = None, rows: Optional[BatchRows] = None):
        """-> (loss, forward outputs) of one micro-batch; ``seed`` draws its
        dropout masks, ``rows`` places it in a global batch."""
        if self.hp.if_dpo:
            from ..models.gpt.dpo import dpo_forward

            out = dpo_forward(self.model, batch,
                              batch["reject_semantic_ids"],
                              batch["reject_semantic_ids_len"], seed=seed,
                              rows=rows)
        else:
            out = self.model(batch["phoneme_ids"], batch["phoneme_ids_len"],
                             batch["semantic_ids"],
                             batch["semantic_ids_len"],
                             batch["bert_feature"], seed=seed, rows=rows)
        return out["loss"], out

    def __call__(self, batch: Dict[str, torch.Tensor],
                 seed: Optional[int] = None,
                 rows: Optional[BatchRows] = None
                 ) -> Dict[str, torch.Tensor]:
        """One micro-batch.  ``seed``: a host integer that draws its dropout
        masks (JAX's per-step dropout rng), needed when the model drops
        (``cfg.dropout > 0``).  ``rows``: on a data-parallel rank, where
        ``batch`` sits in the global micro-batch (the module note)."""
        if seed is None and self.model.cfg.dropout > 0:
            raise ValueError(f"GPTTrainStep: the model drops out (dropout "
                             f"{self.model.cfg.dropout}): a micro-batch "
                             f"needs a seed")
        self.model.train()
        for p in self.params:
            p.grad = None
        loss, out = self.loss(batch, seed, rows)
        loss.backward()
        if rows is not None:
            distributed.reduce_gradients(self.params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        with torch.no_grad():
            grad_norm = torch.sqrt(self._sum_of_squares(grads))
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            if n == self.hp.grad_accum - 1:
                for p, a in zip(self.params, self.acc):
                    p.grad = a
                # a profiler range, so a trace can tell the optimizer's
                # kernels from the step's other elementwise work
                with torch.profiler.record_function(OPTIMIZER_RANGE):
                    self.optimizer.step()
                self.acc = None
                self.mini_step = 0
            else:
                self.mini_step = n + 1
        for p in self.params:
            p.grad = None
        self.step += 1
        if rows is None:
            return {"loss": loss.detach(), "acc": out["acc"].detach(),
                    "grad_norm": grad_norm}
        world = distributed.sum_across_ranks(
            {"loss": loss.detach(), "hits": out["hits"],
             "num": out["num_targets"]})
        return {"loss": world["loss"],
                "acc": world["hits"] / torch.clamp(world["num"], min=1.0),
                "grad_norm": grad_norm}

    def _sum_of_squares(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """sum(g^2) over the whole tensors of ``grads``."""
        if self.shards is None:
            return sum((g.float() ** 2).sum() for g in grads)
        split = [[], []]
        for g, sharded in zip(grads, self.shards.sharded):
            split[sharded].append((g.float() ** 2).sum())
        return sum(split[0]) + distributed.all_reduce_model(
            torch.stack(split[1]).sum())

    # ---- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        """The step's state with whole tensors (under tensor parallelism a
        collective over the model group: every rank of it calls this)."""
        opt = self.optimizer.state_dict()
        if self.shards is None:
            return {"step": self.step, "mini_step": self.mini_step,
                    "acc": self.acc, "optimizer": opt}
        acc = None if self.acc is None else gpt_sharding.gather_whole(
            list(zip(self.names, self.acc)))
        # new dicts: the packed state holds the optimizer's own
        opt["state"] = {i: {k: (gpt_sharding.gather_whole(
            [(self.names[i], v)])[0] if k in SHARDED_STATE else v)
            for k, v in st.items()} for i, st in opt["state"].items()}
        return {"step": self.step, "mini_step": self.mini_step, "acc": acc,
                "optimizer": opt}

    def load_state_dict(self, state: dict) -> None:
        """Loads a :meth:`state_dict` of whole tensors (from any grid); a
        tensor-parallel rank keeps its shards."""
        self.step = int(state["step"])
        self.mini_step = int(state["mini_step"])
        acc, opt = state["acc"], state["optimizer"]
        if self.shards is not None:
            m, n = self.model.tp
            if acc is not None:
                acc = [gpt_sharding.shard_tensor(k, a, m, n)
                       for k, a in zip(self.names, acc)]
            opt = {**opt, "state": {
                i: {k: (gpt_sharding.shard_tensor(self.names[i], v, m, n)
                        if k in SHARDED_STATE else v)
                    for k, v in st.items()}
                for i, st in opt["state"].items()}}
        self.acc = acc
        self.optimizer.load_state_dict(opt)
