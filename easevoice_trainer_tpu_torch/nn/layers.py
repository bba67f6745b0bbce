"""Core layers on torch's ``(B, C, T)`` conv layout.

Counterparts of ``easevoice_trainer_tpu/nn/layers.py``.  Parameters carry the
reference torch state-dict names (``weight_g`` / ``weight_v`` for weight
norm, ``gamma`` / ``beta`` for the channel LayerNorm), so checkpoints that
``train/ckpt.py`` writes load with ``load_state_dict(strict=True)``.

Weight norm: in training mode ``weight`` is ``g * v / ||v||`` computed from
``weight_g`` / ``weight_v`` under autograd on every call, so both receive
gradients.  In eval mode it is a folded buffer, refolded at construction,
after every ``load_state_dict`` and whenever the module leaves training; the
buffer is not part of the state dict.  An in-place edit of ``weight_g`` /
``weight_v`` in eval mode needs :meth:`fold` to take effect.

Dropout draws its masks from an explicit ``torch.Generator`` that the caller
passes down (:func:`dropout`); the global RNG is never used.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask (True inside sequence)."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def weight_norm_key(key: str) -> str:
    """torch's parametrized weight-norm spelling -> ``weight_g``/``weight_v``
    (checkpoints written by ``torch.nn.utils.parametrizations``)."""
    return key.replace("parametrizations.weight.original0", "weight_g") \
        .replace("parametrizations.weight.original1", "weight_v")


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    dims = [d for d in range(v.dim()) if d != dim]
    return torch.linalg.vector_norm(v, dim=dims, keepdim=True)


class _WeightNorm(nn.Module):
    """Holds ``weight_g`` / ``weight_v``; ``weight`` is their product under
    autograd in training and the folded buffer in eval mode."""

    def __init__(self, v_shape, dim: int = 0):
        super().__init__()
        self.wn_dim = dim
        bound = 1.0 / math.sqrt(math.prod(v_shape) // v_shape[dim])
        v = torch.empty(v_shape).uniform_(-bound, bound)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(_norm_except(v, dim))
        self.register_buffer("folded_weight", torch.empty(v_shape),
                             persistent=False)
        self.fold()
        self.register_load_state_dict_post_hook(
            lambda module, _incompatible: module.fold())

    def _compute(self) -> torch.Tensor:
        # the JAX package's _WeightNormKernel: g * v / max(||v||, 1e-12)
        v = self.weight_v
        return self.weight_g * v / _norm_except(v, self.wn_dim).clamp_min(
            1e-12)

    @property
    def weight(self) -> torch.Tensor:
        return self._compute() if self.training else self.folded_weight

    @torch.no_grad()
    def fold(self) -> None:
        self.folded_weight = self._compute().detach()

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:
            self.fold()
        return self


class WNConv1d(_WeightNorm):
    """Weight-normalized Conv1d (torch ``weight_norm``, norm over all axes
    but ``dim``).  ``padding=None`` gives ``(k*d - d) // 2``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, dilation: int = 1,
                 padding=None, groups: int = 1, bias: bool = True,
                 dim: int = 0):
        super().__init__((out_channels, in_channels // groups, kernel_size),
                         dim)
        self.stride = stride
        self.dilation = dilation
        self.padding = ((kernel_size * dilation - dilation) // 2
                        if padding is None else padding)
        self.groups = groups
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class WNConvTranspose1d(_WeightNorm):
    """Weight-normalized ConvTranspose1d, weight (in, out, k), norm per input
    channel; out_len = (T - 1) * stride - 2 * padding + kernel_size."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True):
        super().__init__((in_channels, out_channels, kernel_size), 0)
        self.stride = stride
        self.padding = padding
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias, self.stride,
                                  self.padding)


class WNConv2d(_WeightNorm):
    """Weight-normalized Conv2d (the period discriminators' (k, 1) convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), padding=(0, 0)):
        super().__init__((out_channels, in_channels, *kernel_size), 0)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.gamma[None, :, None] + self.beta[None, :, None]


def dropout(x: torch.Tensor, p: float, training: bool,
            generator) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: keep with probability 1-p and
    scale by 1/(1-p).  The mask comes from ``generator`` (a
    ``torch.Generator`` on ``x``'s device); identity in eval mode or at p=0."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= p
    return x * keep / (1.0 - p)


def slice_segments(x: torch.Tensor, starts: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, segment_size): row b from ``starts[b]``."""
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        segment_size, device=x.device)[None, :]
    return x.gather(2, idx[:, None, :].expand(x.shape[0], x.shape[1], -1))


def rand_slice_starts(lengths: torch.Tensor, segment_size: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Random slice starts as the JAX ``rand_slice_segments`` draws them:
    ``(u * max(len - seg + 1, 1)).int()`` with u ~ U[0, 1) from
    ``generator``."""
    if generator is None:
        raise ValueError("random slice starts need an explicit "
                         "torch.Generator")
    max_start = (lengths - segment_size + 1).clamp_min(1).to(torch.float32)
    u = torch.rand(lengths.shape, generator=generator,
                   device=lengths.device)
    return (u * max_start).to(torch.int64)
