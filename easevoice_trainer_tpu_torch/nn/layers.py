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
passes down (:func:`dropout`); the global RNG is never used.  In a
data-parallel step the caller passes a :class:`RankGenerator` instead: every
draw is then made at the global batch's shape and the rank keeps its own
rows (:func:`random_rows`), so a world of N ranks draws what one process
draws on the whole batch.  Under tensor parallelism a draw for a tensor
whose last axis is sharded (the s1 FFN's hidden layer) is made at the whole
width too, and the rank keeps its column block as well.

Compute dtype (the JAX modules' ``dtype``): a module computes in fp32 unless
:func:`set_compute_dtype` gave it bfloat16, which the fine-tunes do under
``is_half``.  Parameters stay fp32 either way.  In bf16 these layers follow
flax's rules as the JAX package's layers use them: a conv or dense layer
casts its input, weight and bias to bf16, returns bf16 and adds the bias as
a second bf16 rounding; the weight norm's multiply runs in bf16
(``bf16(v) * bf16(g / ||v||)``, the norm in fp32); the channel LayerNorm
takes its statistics in fp32 and returns its input's dtype; a Python
scalar meets a bf16 tensor as a bf16 value (JAX's weak typing,
:func:`weak_scalar`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]
                      ) -> None:
    """Give ``module`` and every submodule the compute dtype ``dtype``
    (None: fp32, the default)."""
    for m in module.modules():
        m.compute_dtype = dtype


def compute_dtype(module: nn.Module) -> Optional[torch.dtype]:
    """The compute dtype :func:`set_compute_dtype` gave ``module`` (None:
    fp32)."""
    return getattr(module, "compute_dtype", None)


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype`` (a weakly
    typed constant, rounded to that dtype first): the value itself for fp32,
    its nearest bf16 for bf16 (0.1 -> 0.10009765625)."""
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))


def wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor in fp32 (where JAX takes a product of bf16 operands
    with ``preferred_element_type=float32``: the products are exact there);
    any other tensor as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` in the compute dtype (unchanged for None)."""
    return t if dtype is None else t.to(dtype)


def conv_in(conv: nn.Conv1d, x: torch.Tensor,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A plain ``nn.Conv1d`` (or a JAX ``nn.Dense`` stored as a 1x1 conv)
    in the compute dtype: ``conv(x)`` for None; in bf16 the input and weight
    cast, the conv's bf16 result, and then the bias added in bf16, as flax
    computes ``nn.Conv(dtype=bf16)``."""
    if dtype is None:
        return conv(x)
    y = F.conv1d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y if conv.bias is None else y + conv.bias.to(dtype)[:, None]


def linear_in(lin: nn.Linear, x: torch.Tensor,
              dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``nn.Linear`` in the compute dtype, as :func:`conv_in`."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask (True inside sequence)."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """JAX's ``where(x >= 0, x, x * slope)``, the slope rounded to x's dtype
    as JAX rounds the constant."""
    return torch.where(x >= 0, x, x * weak_scalar(slope, x.dtype))


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

    def weight_as(self, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """The weight in the compute dtype: :attr:`weight` for None; in bf16
        the JAX package's low-precision multiply (nn/layers.py:102-105),
        ``bf16(v) * bf16(g / max(||v||, 1e-12))`` with the norm in fp32."""
        if dtype is None:
            return self.weight
        v = self.weight_v
        scale = self.weight_g / _norm_except(v, self.wn_dim).clamp_min(1e-12)
        return v.to(dtype) * scale.to(dtype)

    def bias_as(self, dtype: Optional[torch.dtype]):
        return None if self.bias is None else cast(self.bias, dtype)

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
        dtype = compute_dtype(self)
        if dtype is None:
            return F.conv1d(x, self.weight, self.bias, self.stride,
                            self.padding, self.dilation, self.groups)
        y = F.conv1d(x.to(dtype), self.weight_as(dtype), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return y if self.bias is None else y + self.bias_as(dtype)[:, None]


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
        dtype = compute_dtype(self)
        if dtype is None:
            return F.conv_transpose1d(x, self.weight, self.bias, self.stride,
                                      self.padding)
        y = F.conv_transpose1d(x.to(dtype), self.weight_as(dtype), None,
                               self.stride, self.padding)
        return y if self.bias is None else y + self.bias_as(dtype)[:, None]


class WNConv2d(_WeightNorm):
    """Weight-normalized Conv2d (the period discriminators' (k, 1) convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), padding=(0, 0)):
        super().__init__((out_channels, in_channels, *kernel_size), 0)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self)
        if dtype is None:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding)
        y = F.conv2d(x.to(dtype), self.weight_as(dtype), None, self.stride,
                     self.padding)
        return y + self.bias_as(dtype)[:, None, None]


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype       # a bf16 input is normalized in fp32
        x = wide(x)
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma[None, :, None]
                + self.beta[None, :, None]).to(dtype)


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Where one rank's rows sit in a data-parallel step's global batch:
    rows ``[row0, row0 + n)`` of ``total``, n the rank's batch size; and,
    under tensor parallelism, its column block ``col_block`` of
    ``col_blocks`` (its model index of n_model) along a sharded last
    axis."""

    row0: int
    total: int
    col_block: int = 0
    col_blocks: int = 1


class RankGenerator:
    """A ``torch.Generator`` as one rank of a data-parallel world draws from
    it: every draw of :func:`random_rows` is made at the global batch's
    shape (``rows.total`` rows) and the rank keeps rows ``rows.row0 ..``;
    with ``columns`` (:meth:`column_block`), for a tensor whose last axis
    is sharded over the model group, the draw is made at the whole width
    and the rank keeps its column block too.  Every rank seeds its
    generator alike and draws the same global shapes in the same order, so
    the generators stay in step across the world, the ranks of a model
    group included."""

    def __init__(self, generator: torch.Generator, rows: BatchRows,
                 columns: bool = False):
        self.generator = generator
        self.rows = rows
        self.columns = columns

    def column_block(self) -> "RankGenerator":
        """This generator (the same ``torch.Generator``) drawing for a
        column-sharded tensor."""
        return RankGenerator(self.generator, self.rows, columns=True)


Generator = Union[torch.Generator, RankGenerator]


def random_rows(draw, shape, generator: Generator, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``draw(shape, generator=..., device=..., dtype=...)`` (``torch.rand``
    or ``torch.randn``) of a batch-first ``shape``; from a
    :class:`RankGenerator`, the rank's rows of the draw at the global
    batch's shape, and, drawing for a column-sharded tensor, its column
    block of the draw at the whole width."""
    if not isinstance(generator, RankGenerator):
        return draw(tuple(shape), generator=generator, device=device,
                    dtype=dtype)
    rows = generator.rows
    whole = [rows.total, *shape[1:]]
    blocks = rows.col_blocks if generator.columns else 1
    whole[-1] *= blocks
    full = draw(tuple(whole), generator=generator.generator, device=device,
                dtype=dtype)[rows.row0:rows.row0 + shape[0]]
    if blocks == 1:
        return full
    c0 = rows.col_block * shape[-1]
    return full[..., c0:c0 + shape[-1]]


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[Generator]) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: keep with probability 1-p and
    scale by 1/(1-p).  The mask comes from ``generator`` (a
    ``torch.Generator`` on ``x``'s device, or a :class:`RankGenerator`);
    identity in eval mode or at p=0, zeros at p=1 (flax's rate-1 case, which
    draws nothing).  The uniforms are fp32 whatever ``x.dtype`` is, as flax
    draws ``bernoulli(rng, 1 - p)`` from a Python float: drawn in bf16 they
    take some 2^8 values below 1 and drop at a rate well off p (0.102 for
    0.1)."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator")
    keep = random_rows(torch.rand, x.shape, generator, x.device) >= p
    return x * keep / weak_scalar(1.0 - p, x.dtype)


def slice_segments(x: torch.Tensor, starts: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, segment_size): row b from ``starts[b]``."""
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        segment_size, device=x.device)[None, :]
    return x.gather(2, idx[:, None, :].expand(x.shape[0], x.shape[1], -1))


def rand_slice_starts(lengths: torch.Tensor, segment_size: int,
                      generator: Generator) -> torch.Tensor:
    """Random slice starts as the JAX ``rand_slice_segments`` draws them:
    ``(u * max(len - seg + 1, 1)).int()`` with u ~ U[0, 1) from
    ``generator``."""
    if generator is None:
        raise ValueError("random slice starts need an explicit "
                         "torch.Generator")
    max_start = (lengths - segment_size + 1).clamp_min(1).to(torch.float32)
    u = random_rows(torch.rand, lengths.shape, generator, lengths.device)
    return (u * max_start).to(torch.int64)
