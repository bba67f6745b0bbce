"""KV-cached autoregressive decoding for the s1 GPT (JAX: models/gpt/decode.py).

The cache is preallocated at ``x_len + prompt_len + max_new_tokens`` and
written in place.  The loop runs on the host one step at a time; finished
rows keep feeding EOS while the rest of the batch continues, and every
``CHECK_EVERY`` steps one host read of ``done.all()`` ends the loop early.
Finished rows are EOS-filled and their lengths frozen, so checking less
often than every step changes no result.  Sampling keeps the reference order
(repetition penalty -> top-p -> temperature -> top-k -> categorical) with the
exponential-race categorical drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# steps between host reads of done.all(); each read waits for the card
CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    top_k: int = 15
    top_p: float = 1.0
    temperature: float = 1.0
    repetition_penalty: float = 1.35
    max_new_tokens: int = 1500
    early_stop_num: int = -1     # stop after this many new tokens if > 0
    min_tokens: int = 10         # EOS suppressed for the first N steps


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             history_valid: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Penalize every vocab id present in ``history``.

    logits: (B, V); history: (B, H) int; history_valid: (B, H) bool.
    """
    if penalty == 1.0:
        return logits
    v = logits.shape[1]
    clipped = history.clamp(0, v - 1).to(torch.int64)
    present = torch.zeros_like(logits, dtype=torch.int32).scatter_reduce(
        1, clipped, history_valid.to(torch.int32), reduce="amax") > 0
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(present, penalized, logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    if top_p >= 1.0:
        return logits
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum > top_p
    remove_sorted[:, 0] = False
    remove = torch.zeros_like(remove_sorted).scatter(1, sorted_idx,
                                                     remove_sorted)
    return logits.masked_fill(remove, -float("inf"))


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, -float("inf"))


def sample_token(logits: torch.Tensor, history: torch.Tensor,
                 history_valid: torch.Tensor, p: DecodeParams,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) sampled token ids, reference op order."""
    logits = logits.float()
    logits = apply_repetition_penalty(logits, history, history_valid,
                                      p.repetition_penalty)
    logits = apply_top_p(logits, p.top_p)
    logits = logits / max(p.temperature, 1e-5)
    logits = apply_top_k(logits, p.top_k)
    probs = torch.softmax(logits, dim=-1)
    # exponential race == categorical sample
    q = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / q).argmax(dim=-1)


@torch.no_grad()
def decode_ar(model, x: torch.Tensor, x_lens: torch.Tensor,
              prompts: torch.Tensor, bert_feature: torch.Tensor,
              params: DecodeParams = DecodeParams(),
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate semantic tokens.

    x: (B, Tx) phoneme ids (padded); x_lens: (B,); prompts: (B, Tp);
    bert_feature: (B, Tx, 1024).  Returns (tokens (B, max_new_tokens) with
    EOS after the stop, lengths (B,) = tokens generated before EOS).
    """
    eos = model.cfg.eos_id
    b, x_len = x.shape
    prompt_len = prompts.shape[1]
    max_new = params.max_new_tokens
    dev = x.device
    x_lens = x_lens.to(torch.int32)

    logits, k_caches, v_caches = model.prefill(
        x, x_lens, prompts, bert_feature, x_len + prompt_len + max_new)

    history = torch.cat([prompts.to(torch.int64),
                         torch.full((b, max_new), eos, dtype=torch.int64,
                                    device=dev)], dim=1)
    hist_valid = torch.zeros((b, prompt_len + max_new), dtype=torch.bool,
                             device=dev)
    hist_valid[:, :prompt_len] = True
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tokens = torch.full((b, max_new), eos, dtype=torch.int64, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int64, device=dev)

    for step in range(max_new):
        lg = logits.float()
        if step < params.min_tokens:
            lg = lg.clone()
            lg[:, eos] = -float("inf")
        sampled = sample_token(lg, history, hist_valid, params, generator)
        hits_eos = (sampled == eos) | (lg.argmax(dim=-1) == eos)
        stopped = done | hits_eos
        token = torch.where(stopped, eos, sampled)
        tokens[:, step] = token
        lengths = torch.where(stopped, lengths, lengths + 1)
        history[:, prompt_len + step] = token
        hist_valid[:, prompt_len + step] = ~stopped
        done = stopped
        if 0 < params.early_stop_num <= step + 1:
            break
        if step + 1 == max_new or (
                (step + 1) % CHECK_EVERY == 0 and bool(done.all())):
            break
        logits = model.decode_step(token, step, k_caches, v_caches, x_len,
                                   x_lens, prompt_len)
    return tokens, lengths
