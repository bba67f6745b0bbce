"""ScaledAdam (k2/icefall) as a ``torch.optim.Optimizer`` (JAX:
train/scaled_adam.py ``scaled_adam``, per tensor: its ``rowwise`` math
with each tensor one row).

Adam whose per-tensor step is proportional to the tensor's RMS, plus an
explicit learned parameter-scale update.  The fine print, as the JAX
transformation has it:

* clipping keeps a ``clipping_update_period``-slot ring of RMS-weighted
  global gradient norms; the threshold is ``clipping_scale`` x the (lower)
  median, refreshed every period, and nothing is clipped before the first
  full period;
* the clip factor multiplies only the size-update gradients; the core Adam
  update reads the raw gradient;
* the v-hat bias correction applies only while ``1 - beta2^t < 0.99``;
* every ``size_update_period`` steps (not step 0) the RMS is refreshed and
  the scale takes an Adam step on the period's scale gradients
  ``sum(p * g_clipped)``; undersized tensors stop shrinking, oversized ones
  get a fixed push;
* one-element tensors: plain Adam at ``lr * scalar_lr_scale`` with the
  value clamped to +-scalar_max first.

``exp_avg_sq`` and ``delta`` are stored in bf16 unless
``EASEVOICE_OPT_STATE=fp32`` (``train/optim_lowp.moment_dtype``), upcast on
read and rounded on store; the math is fp32.  The per-tensor scalars and
the clip ring stay fp32.  Everything stays on the parameters' device: the
clip factor is a device scalar, so a step never waits for the card.

The global state (``step``, the ``norm_buffer`` ring, ``norm_threshold``)
lives in the single parameter group, so ``state_dict`` carries it.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from .optim_lowp import moment_dtype


class ScaledAdam(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: float = 0.002, betas=(0.9, 0.95), eps: float = 1e-8,
                 min_rms: float = 1e-5, max_rms: float = 3.0,
                 size_update_period: int = 4, scalar_lr_scale: float = 0.1,
                 scalar_max: float = 10.0, clipping_scale: float = 2.0,
                 clipping_update_period: int = 1000,
                 state_dtype: Optional[torch.dtype] = None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, min_rms=min_rms,
                        max_rms=max_rms,
                        size_update_period=size_update_period,
                        scalar_lr_scale=scalar_lr_scale,
                        scalar_max=scalar_max, clipping_scale=clipping_scale,
                        clipping_update_period=clipping_update_period)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("ScaledAdam: one parameter group (its clipping "
                             "norm is global)")
        group = self.param_groups[0]
        dev = group["params"][0].device
        group["step"] = 0
        group["norm_buffer"] = torch.zeros(clipping_update_period,
                                           dtype=torch.float32, device=dev)
        group["norm_threshold"] = torch.full((), float("inf"),
                                             dtype=torch.float32, device=dev)
        self.state_dtype = state_dtype if state_dtype is not None \
            else moment_dtype()
        # the state of each tensor from its value now, as the JAX init_fn
        # takes it from the parameters it is given
        with torch.no_grad():
            for p in group["params"]:
                p32 = p.detach().float()
                self.state[p] = {
                    "exp_avg_sq": torch.zeros_like(p, dtype=self.state_dtype),
                    "delta": torch.zeros_like(p, dtype=self.state_dtype),
                    "param_rms": (torch.zeros((), device=p.device)
                                  if p.numel() == 1 else
                                  p32.pow(2).mean().sqrt()),
                    "scale_exp_avg_sq": torch.zeros((), device=p.device),
                    "scale_grads": torch.zeros(size_update_period,
                                               device=p.device),
                }

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p in params]
        step = group["step"]
        lr = group["lr"]
        b1, b2 = group["betas"]
        eps, min_rms, max_rms = group["eps"], group["min_rms"], \
            group["max_rms"]
        K = group["size_update_period"]
        period = group["clipping_update_period"]
        cscale = group["clipping_scale"]
        dev = params[0].device
        f32 = dict(dtype=torch.float32, device=dev)

        # ---- adaptive clipping: ring of RMS-weighted global norms --------
        tot = torch.zeros((), **f32)
        for p, g in zip(params, grads):
            sumsq = (g * g).sum()
            if p.numel() != 1:
                sumsq = self.state[p]["param_rms"] ** 2 * sumsq
            tot = tot + sumsq
        tot_norm = tot.sqrt()
        group["norm_buffer"][step % period] = tot_norm
        if step % period == 0 and step > 0:
            median = torch.sort(group["norm_buffer"]).values[
                min(period - 1, (period // 4) * 2)]
            group["norm_threshold"] = cscale * median
        if step < period:
            clip = torch.ones((), **f32)
        else:
            clip = torch.clamp(group["norm_threshold"] / (tot_norm + 1e-20),
                               max=1.0)

        bc2 = 1.0 - torch.tensor(b2, **f32) ** torch.tensor(step + 1.0,
                                                             **f32)
        is_refresh = step % K == K - 1
        do_size = is_refresh and step > 0
        beta2_corr = b2 ** K
        size_lr = lr * group["scalar_lr_scale"]

        for p, g in zip(params, grads):
            st = self.state[p]
            p32 = p.detach().float()
            v = st["exp_avg_sq"].float()
            d = b1 * st["delta"].float()
            if p.numel() == 1:
                v = b2 * v + (1.0 - b2) * g * g
                denom = (v / bc2).sqrt() + eps
                d = d + (-lr * group["scalar_lr_scale"] * (1.0 - b1)) * g \
                    / denom
                new = p32.clamp(-group["scalar_max"], group["scalar_max"]) + d
            else:
                # size bookkeeping reads the clipped gradient
                st["scale_grads"][step % K] = (p32 * (g * clip)).sum()
                if is_refresh:
                    st["param_rms"] = p32.pow(2).mean().sqrt()
                rms = st["param_rms"]
                if do_size:
                    sg = st["scale_grads"]
                    s_v = beta2_corr * st["scale_exp_avg_sq"] \
                        + (1.0 - beta2_corr) * (sg * sg).mean()
                    bc2s = 1.0 - torch.tensor(beta2_corr, **f32) \
                        ** torch.tensor(float((step + 1) // K), **f32)
                    scale_step = (-size_lr * bc2s.sqrt() * sg.sum()
                                  / (s_v.sqrt() + eps))
                    scale_step = torch.where(rms < min_rms,
                                             torch.zeros((), **f32),
                                             scale_step)
                    scale_step = torch.where(
                        rms > max_rms, torch.full((), -size_lr * K, **f32),
                        scale_step)
                    d = d + ((1.0 - b1) * scale_step) * p32
                    st["scale_exp_avg_sq"] = s_v
                # the core update reads the raw gradient
                v = b2 * v + (1.0 - b2) * g * g
                vhat = torch.where(bc2 < 0.99, v / bc2, v)
                denom = vhat.sqrt() + eps
                alpha = -lr * (1.0 - b1) * torch.clamp(rms, min=min_rms)
                d = d + alpha * g / denom
                new = p32 + d
            # optax applies (new - p) to p
            p.add_((new - p32).to(p.dtype))
            st["exp_avg_sq"] = v.to(self.state_dtype)
            st["delta"] = d.to(self.state_dtype)
        group["step"] = step + 1
        return loss
