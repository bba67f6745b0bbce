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
from .scaled_adam import ScaledAdam


LOCKED_LR = 0.002
BETAS = (0.9, 0.95)
CLIPPING_SCALE = 2.0


@dataclasses.dataclass(frozen=True)
class GPTTrainHP:
    grad_accum: int = 4
    if_dpo: bool = False


OPTIMIZER_RANGE = "ScaledAdam.step"


class GPTTrainStep:
    """One micro-batch of the s1 fine-tune: forward, backward, accumulate,
    and an optimizer step on every ``hp.grad_accum``-th call."""

    def __init__(self, model: Text2SemanticDecoder, hp: GPTTrainHP):
        self.model = model
        self.hp = hp
        self.params: List[torch.nn.Parameter] = list(model.parameters())
        self.optimizer = ScaledAdam(self.params, lr=LOCKED_LR, betas=BETAS,
                                    clipping_scale=CLIPPING_SCALE)
        self.step = 0          # micro-batches taken
        self.mini_step = 0     # position inside the accumulation window
        self.acc: Optional[List[torch.Tensor]] = None

    def loss(self, batch: Dict[str, torch.Tensor],
             seed: Optional[int] = None):
        """-> (loss, forward outputs) of one micro-batch; ``seed`` draws its
        dropout masks."""
        if self.hp.if_dpo:
            from ..models.gpt.dpo import dpo_forward

            out = dpo_forward(self.model, batch,
                              batch["reject_semantic_ids"],
                              batch["reject_semantic_ids_len"], seed=seed)
        else:
            out = self.model(batch["phoneme_ids"], batch["phoneme_ids_len"],
                             batch["semantic_ids"],
                             batch["semantic_ids_len"],
                             batch["bert_feature"], seed=seed)
        return out["loss"], out

    def __call__(self, batch: Dict[str, torch.Tensor],
                 seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One micro-batch.  ``seed``: a host integer that draws its dropout
        masks (JAX's per-step dropout rng), needed when the model drops
        (``cfg.dropout > 0``)."""
        if seed is None and self.model.cfg.dropout > 0:
            raise ValueError(f"GPTTrainStep: the model drops out (dropout "
                             f"{self.model.cfg.dropout}): a micro-batch "
                             f"needs a seed")
        self.model.train()
        for p in self.params:
            p.grad = None
        loss, out = self.loss(batch, seed)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        with torch.no_grad():
            grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
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
        return {"loss": loss.detach(), "acc": out["acc"].detach(),
                "grad_norm": grad_norm}

    # ---- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        return {"step": self.step, "mini_step": self.mini_step,
                "acc": self.acc, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.mini_step = int(state["mini_step"])
        self.acc = state["acc"]
        self.optimizer.load_state_dict(state["optimizer"])
