"""s2 SoVITS GAN train step (JAX: train/sovits_step.py).

One step is, in the order of the reference loop:

1. the generator forward, run once (a random 32-frame latent slice ->
   HiFi-GAN waveform; its ResBlocks run on K3);
2. the discriminator step on (real slice, ``y_hat.detach()``), LSGAN loss,
   AdamW(0.8, 0.99, eps 1e-9) with the per-epoch exponential LR decay;
3. the generator step against the *updated* discriminator: adversarial +
   feature matching + 45 * mel-L1 + KL + commit.  The real feature maps are
   computed without a graph and D's parameters are frozen meanwhile, so D
   gets no gradient from it.  The backward through the ResBlocks runs on K4.

Both models compute in their compute dtype (bf16 under ``is_half``, JAX
``train/sovits.py:204-206``); the mel spectrogram of ``y_hat``, the mel L1
and every loss reduction are fp32 (JAX ``sovits_step.py:233``,
``losses.py``), and the parameters and their gradients stay fp32.

The generator has two LR groups: ``enc_p.text_embedding``,
``enc_p.encoder_text`` and ``enc_p.mrte`` at ``text_low_lr_rate``, the rest
at the base rate, ``lr * decay ** (step // steps_per_epoch)``.

Data parallel (``parallel/``): a rank passes ``rows``, where its rows sit
in the global batch.  Its draws (slice starts, posterior noise, dropout
masks) are its rows of the global batch's (``nn.layers.RankGenerator``),
and each loss is its share of the global batch's: a mean over a
batch-first tensor (the LSGAN terms, feature matching, mel L1, commit) is
the local mean x local rows / global rows, which is the local sum over the
global count, and the KL divides by the world's mask count.  Each backward
is followed by one all-reduce summing the gradients over the world
(``reduce_gradients``), the D one before ``grad_norm/d`` and ``optim_d``,
the G one before ``grad_norm/g`` and ``optim_g``; the losses are summed
over the world (``sum_across_ranks``), so every rank reports the global
batch's metrics, as JAX does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.sovits import losses
from ..models.sovits.discriminator import MultiPeriodDiscriminator
from ..models.sovits.synthesizer import SynthesizerTrn
from ..nn.layers import BatchRows, RankGenerator, slice_segments
from ..parallel import distributed
from ..ops.stft import MelConfig, mel_spectrogram, spec_to_mel
from .optim_lowp import AdamWLowp

TEXT_LOW_LR_PREFIXES = ("enc_p.text_embedding", "enc_p.encoder_text",
                        "enc_p.mrte")


@dataclasses.dataclass(frozen=True)
class S2TrainHP:
    """Mirrors configs/s2.json "train" (JAX: sovits_step.py S2TrainHP)."""

    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    segment_size: int = 20480
    c_mel: float = 45.0
    c_kl: float = 1.0
    text_low_lr_rate: float = 0.4
    weight_decay: float = 0.01   # torch AdamW default


def _global_norm(params) -> torch.Tensor:
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class S2TrainStep:
    """Holds the two models and their optimizers; ``__call__`` runs one
    D-then-G step on a batch of tensors on the models' device."""

    def __init__(self, net_g: SynthesizerTrn,
                 net_d: MultiPeriodDiscriminator, hp: S2TrainHP,
                 mel_cfg: MelConfig, steps_per_epoch: int = 1):
        self.net_g, self.net_d = net_g, net_d
        self.hp, self.mel_cfg = hp, mel_cfg
        self.seg_frames = hp.segment_size // mel_cfg.hop_length
        spe = max(steps_per_epoch, 1)

        def lr_fn(count: int) -> float:
            return hp.learning_rate * hp.lr_decay ** (count // spe)

        text, base = [], []
        for name, p in net_g.named_parameters():
            if p.requires_grad:
                (text if name.startswith(TEXT_LOW_LR_PREFIXES)
                 else base).append(p)
        kw = dict(betas=hp.betas, eps=hp.eps, weight_decay=hp.weight_decay)
        self.optim_g = AdamWLowp(
            [{"params": base}, {"params": text,
                                "lr_scale": hp.text_low_lr_rate}],
            lr_fn, **kw)
        self.optim_d = AdamWLowp([{"params": list(net_d.parameters())}],
                                 lr_fn, **kw)

    @property
    def step(self) -> int:
        return self.optim_g.count

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 ids_slice: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None,
                 rows: Optional[BatchRows] = None
                 ) -> Dict[str, torch.Tensor]:
        """batch: ``collate_s2``'s keys as tensors.  ``generator`` draws the
        slice starts, the posterior noise and the dropout masks unless
        ``ids_slice`` / ``eps`` are given.  ``rows``: on a data-parallel
        rank, where ``batch`` sits in the global batch (the module note).
        Returns the JAX step's metrics as 0-d tensors (no host sync
        outside data parallel)."""
        hp, mel_cfg = self.hp, self.mel_cfg
        if rows is not None:
            share = batch["ssl"].shape[0] / rows.total
            if isinstance(generator, torch.Generator):
                generator = RankGenerator(generator, rows)
        self.net_g.train()
        self.net_d.train()
        y_hat, commit, ids_slice, y_mask, latents = self.net_g(
            batch["ssl"], batch["spec"], batch["spec_lengths"],
            batch["text"], batch["text_lengths"], generator=generator,
            ids_slice=ids_slice, eps=eps)
        _, z_p, m_p, logs_p, _, logs_q = latents

        with torch.no_grad():
            mel = spec_to_mel(batch["spec"], mel_cfg)
            y_mel = slice_segments(mel.transpose(1, 2), ids_slice,
                                   self.seg_frames)
            y = slice_segments(batch["wav"][:, None], ids_slice *
                               mel_cfg.hop_length, hp.segment_size)
        y_hat = y_hat.transpose(1, 2)                       # (B, 1, seg)

        # ---- discriminator step ----
        self.optim_d.zero_grad()
        real_l, fake_l, _, _ = self.net_d(y, y_hat.detach())
        loss_disc, _, _ = losses.discriminator_loss(real_l, fake_l)
        if rows is not None:
            loss_disc = loss_disc * share
        loss_disc.backward()
        if rows is not None:
            distributed.reduce_gradients(self.optim_d.params())
        grad_norm_d = _global_norm(self.optim_d.params())
        self.optim_d.step()

        # ---- generator step, against the updated discriminator ----
        self.optim_g.zero_grad()
        self.net_d.requires_grad_(False)
        try:
            with torch.no_grad():
                _, fmap_r = self.net_d.run(y)
            fake_l, fmap_g = self.net_d.run(y_hat)
            y_hat_mel = mel_spectrogram(y_hat[:, 0], mel_cfg).transpose(1, 2)
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * hp.c_mel
            count = None
            if rows is not None:
                count = distributed.sum_across_ranks(
                    {"n": y_mask.float().sum()})["n"]
            loss_kl = losses.kl_loss(z_p, logs_q, m_p, logs_p, y_mask,
                                     count) * hp.c_kl
            loss_fm = losses.feature_matching_loss(fmap_r, fmap_g)
            loss_adv, _ = losses.generator_adv_loss(fake_l)
            if rows is not None:
                loss_mel, loss_fm, loss_adv, commit = (
                    t * share for t in (loss_mel, loss_fm, loss_adv, commit))
            total = loss_adv + loss_fm + loss_mel + commit + loss_kl
            total.backward()
        finally:
            self.net_d.requires_grad_(True)
        if rows is not None:
            distributed.reduce_gradients(self.optim_g.params())
        grad_norm_g = _global_norm(self.optim_g.params())
        self.optim_g.step()
        metrics = {
            "loss/g/total": total.detach(), "loss/g/adv": loss_adv.detach(),
            "loss/g/fm": loss_fm.detach(), "loss/g/mel": loss_mel.detach(),
            "loss/g/kl": loss_kl.detach(), "loss/g/commit": commit.detach(),
            "loss/d/total": loss_disc.detach(),
        }
        if rows is not None:
            metrics = distributed.sum_across_ranks(metrics)
        return {**metrics, "grad_norm/g": grad_norm_g,
                "grad_norm/d": grad_norm_d}
