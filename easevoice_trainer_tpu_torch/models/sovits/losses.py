"""GAN + VAE losses of the s2 step (JAX: models/sovits/losses.py); every
reduction is taken in fp32."""
from __future__ import annotations

from typing import Optional

import torch


def feature_matching_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float()
                                               - gl.float()))
    return loss * 2.0


def discriminator_loss(real_outputs, fake_outputs):
    """LSGAN D loss: (1 - D(y))^2 + D(y_hat)^2 per sub-discriminator."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, fake_outputs):
        r = torch.mean((1.0 - dr.float()) ** 2)
        g = torch.mean(dg.float() ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_adv_loss(fake_outputs):
    loss = 0.0
    gen_losses = []
    for dg in fake_outputs:
        one = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(one)
        loss = loss + one
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(q || p) between the flowed posterior and the prior, masked mean.
    ``count``: the mean's denominator, ``sum(z_mask)`` unless given (a
    data-parallel rank gives the world's, so its KL is its share of the
    global batch's)."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if count is None
                                     else count)
