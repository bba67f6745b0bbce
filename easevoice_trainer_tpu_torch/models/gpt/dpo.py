"""DPO preference objective for GPT training (JAX: models/gpt/dpo.py).

A "rejected" semantic sequence is made from the target by repeating a
random span (the reference's repeat_P corruption, on the host with numpy),
the model scores both, and a reference-free sigmoid preference loss on the
sequence log-prob margin is added to the CE loss.  Off by default
(``GPTTrainParams.if_dpo``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...nn.layers import BatchRows


def make_reject_y(y: np.ndarray, y_lens: np.ndarray,
                  rng: np.random.Generator,
                  max_len: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt each row by repeating a random token span (repeat_P).

    y: (B, T) int; returns (reject_y (B, T'), reject_lens) padded with
    zeros."""
    B, T = y.shape
    max_len = max_len or T
    rows = []
    lens = []
    for b in range(B):
        L = int(y_lens[b])
        row = y[b, :L]
        lo, hi = sorted(rng.integers(0, max(L, 1), size=2).tolist())
        new = np.concatenate([row[:lo], row[lo:hi], row[lo:hi], row[hi:]])
        new = new[:max_len]
        lens.append(len(new))
        rows.append(new)
    width = max(max_len, max(lens))
    out = np.zeros((B, width), y.dtype)
    for b, row in enumerate(rows):
        out[b, :len(row)] = row
    return out, np.asarray(lens, np.int32)


def sequence_logps(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Sum of per-token target log-probs per row."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None].long())[..., 0].sum(-1)


def dpo_loss(chosen_logps: torch.Tensor, rejected_logps: torch.Tensor,
             beta: float = 0.2) -> torch.Tensor:
    """Reference-free DPO."""
    margin = chosen_logps - rejected_logps
    return -F.logsigmoid(beta * margin).mean()


def dpo_forward(model, batch: Dict[str, torch.Tensor], reject_y: torch.Tensor,
                reject_lens: torch.Tensor, seed: Optional[int] = None,
                rows: Optional[BatchRows] = None) -> Dict[str, torch.Tensor]:
    """Chosen and rejected forwards of ``model`` combined.  Both take
    ``seed``, the dropout seed, so they drop the same elements (the
    rejected sequences are padded to the chosen ones' length), as the JAX
    passes share their ``rngs``.  ``rows``: on a data-parallel rank, where
    the batch sits in the global batch; the means over rows (the DPO term,
    the margin) are then the rank's share of the global batch's, its local
    mean x local rows / global rows."""
    out = model(batch["phoneme_ids"], batch["phoneme_ids_len"],
                batch["semantic_ids"], batch["semantic_ids_len"],
                batch["bert_feature"], seed=seed, rows=rows)
    out_rej = model(batch["phoneme_ids"], batch["phoneme_ids_len"], reject_y,
                    reject_lens, batch["bert_feature"], seed=seed, rows=rows)
    chosen = sequence_logps(out["logits"], out["targets"])
    rejected = sequence_logps(out_rej["logits"], out_rej["targets"])
    pref, margin = dpo_loss(chosen, rejected), (chosen - rejected).mean()
    if rows is not None:
        share = chosen.shape[0] / rows.total
        pref, margin = pref * share, margin * share
    return {"loss": out["loss"] + pref, "acc": out["acc"],
            "hits": out["hits"], "num_targets": out["num_targets"],
            "ce_loss": out["loss"], "dpo_margin": margin}
