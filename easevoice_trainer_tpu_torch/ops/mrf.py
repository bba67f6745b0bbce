"""K3 and K4: the leaky-relu -> dilated conv -> bias (+ residual) step of the
HiFi-GAN MRF ResBlocks, forward and backward.

``mrf_conv`` is one ``torch.autograd.Function`` on both devices.  On the CPU
its forward and backward run the plain twins (:func:`mrf_conv_reference`,
:func:`mrf_conv_bwd_data_reference`, :func:`mrf_conv_bwd_weight_reference`);
on a CUDA tensor they launch the hand-written kernels ``csrc/mrf_conv.cu``
(K3) and ``csrc/mrf_conv_bwd.cu`` (K4: data and weight gradients) or raise.
``mrf_conv.launches``, ``mrf_conv_bwd_data.launches`` and
``mrf_conv_bwd_weight.launches`` count kernel launches.

The backward twins are written as explicit formulas, not as autograd of
``F.conv1d``, so that the twin K4 is held against is itself held against
``jax.vjp`` of the JAX ResBlock math in the tests:

* ``dx = lrelu'(x) * conv_transpose1d(dy, w, dilation)`` (lrelu'(0) = 1);
* ``dw = conv1d_weight(lrelu(x), dy)``, ``db = sum dy``;
* ``d residual = dy``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.layers import LRELU_SLOPE, leaky_relu
from . import build

# samples of one batch row per partial sum of K4's weight gradient
WGRAD_CHUNK = 512


def _pad(k: int, dilation: int) -> int:
    return (k - 1) * dilation // 2


def mrf_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int,
                       residual: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain twin: conv1d(leaky_relu(x), w, dilation, same padding) + b
    (+ residual), the JAX ResBlock math (models/sovits/generator.py:31-44)."""
    y = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w, b,
                 padding=_pad(w.shape[-1], dilation), dilation=dilation)
    return y if residual is None else y + residual


def mrf_conv_bwd_data_reference(dy: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor,
                                dilation: int) -> torch.Tensor:
    """Plain twin of K4's data gradient:
    dx = lrelu'(x) * conv_transpose1d(dy, w, dilation, same padding)."""
    da = F.conv_transpose1d(dy, w, padding=_pad(w.shape[-1], dilation),
                            dilation=dilation)
    return torch.where(x >= 0, da, da * LRELU_SLOPE)


def mrf_conv_bwd_weight_reference(dy: torch.Tensor, x: torch.Tensor,
                                  w_shape, dilation: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4's weight gradient: (dw, db) with
    dw = conv1d_weight(lrelu(x), dy) and db = sum of dy over batch and time."""
    dw = torch.nn.grad.conv1d_weight(
        leaky_relu(x), tuple(w_shape), dy,
        padding=_pad(w_shape[-1], dilation), dilation=dilation)
    return dw, dy.sum(dim=(0, 2))


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: all tensors must be fp32 on one CUDA "
                             "device")


def _check_shapes(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    cout, cin, k = w.shape
    if x.dim() != 3 or x.shape[1] != cin or k % 2 == 0:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _mrf_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   dilation: int,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on CUDA tensors (no autograd); see :func:`mrf_conv`."""
    tensors = [x, w, b] + ([residual] if residual is not None else [])
    _check_cuda("mrf_conv", *tensors)
    _check_shapes("mrf_conv", x, w)
    bsz, cin, t_len = x.shape
    cout, _, k = w.shape
    if b.shape != (cout,):
        raise ValueError(f"mrf_conv: bias must be ({cout},)")
    if residual is not None and residual.shape != (bsz, cout, t_len):
        raise ValueError("mrf_conv: residual must be (B, Cout, T)")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    residual = residual.contiguous() if residual is not None else None
    y = torch.empty((bsz, cout, t_len), dtype=torch.float32, device=x.device)
    lib = build.build()
    rc = lib.ev_mrf_conv_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        bsz, cin, cout, t_len, k, int(dilation), LRELU_SLOPE, _stream(x))
    build.check(rc, "mrf_conv")
    mrf_conv.launches += 1
    return y


def mrf_conv_bwd_data(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      dilation: int) -> torch.Tensor:
    """dx of K3 (dy: (B, Cout, T), x: the forward's input (B, Cin, T)); the
    plain twin on the CPU, K4 on CUDA."""
    if x.device.type == "cpu":
        return mrf_conv_bwd_data_reference(dy, x, w, dilation)
    _check_cuda("mrf_conv_bwd_data", dy, x, w)
    _check_shapes("mrf_conv_bwd_data", x, w)
    bsz, cin, t_len = x.shape
    cout, _, k = w.shape
    if dy.shape != (bsz, cout, t_len):
        raise ValueError("mrf_conv_bwd_data: dy must be (B, Cout, T)")
    dy, x, w = dy.contiguous(), x.contiguous(), w.contiguous()
    dx = torch.empty_like(x)
    rc = build.build().ev_mrf_conv_bwd_data_f32(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), bsz, cin,
        cout, t_len, k, int(dilation), LRELU_SLOPE, _stream(x))
    build.check(rc, "mrf_conv_bwd_data")
    mrf_conv_bwd_data.launches += 1
    return dx


def mrf_conv_bwd_weight(dy: torch.Tensor, x: torch.Tensor, w_shape,
                        dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of K3; the plain twin on the CPU, K4 on CUDA (partial sums
    over ``WGRAD_CHUNK``-sample chunks, then a fixed-order reduction)."""
    if x.device.type == "cpu":
        return mrf_conv_bwd_weight_reference(dy, x, w_shape, dilation)
    _check_cuda("mrf_conv_bwd_weight", dy, x)
    cout, cin, k = (int(s) for s in w_shape)
    bsz, t_len = x.shape[0], x.shape[-1]
    if (x.dim() != 3 or x.shape[1] != cin or k % 2 == 0 or k > 16
            or dy.shape != (bsz, cout, t_len)):
        raise ValueError(f"mrf_conv_bwd_weight: bad shapes x"
                         f"{tuple(x.shape)} dy{tuple(dy.shape)} w{w_shape}")
    dy, x = dy.contiguous(), x.contiguous()
    n_chunks = bsz * -(-t_len // WGRAD_CHUNK)
    dev = x.device
    dw = torch.empty((cout, cin, k), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    part_w = torch.empty((n_chunks, cout, cin, k), dtype=torch.float32,
                         device=dev)
    part_b = torch.empty((n_chunks, cout), dtype=torch.float32, device=dev)
    rc = build.build().ev_mrf_conv_bwd_weight_f32(
        dy.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), bsz, cin, cout, t_len, k,
        int(dilation), LRELU_SLOPE, WGRAD_CHUNK, _stream(x))
    build.check(rc, "mrf_conv_bwd_weight")
    mrf_conv_bwd_weight.launches += 1
    return dw, db


class _MRFConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dilation, residual):
        ctx.dilation = dilation
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return mrf_conv_reference(x, w, b, dilation, residual)
        return _mrf_conv_cuda(x, w, b, dilation, residual)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            dx = mrf_conv_bwd_data(dy, x, w, ctx.dilation)
        if need_w or need_b:
            dw, db = mrf_conv_bwd_weight(dy, x, w.shape, ctx.dilation)
        dres = dy if ctx.has_residual and ctx.needs_input_grad[4] else None
        return dx, dw if need_w else None, db if need_b else None, None, dres


def mrf_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dilation: int,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, Cin, T) fp32; w: (Cout, Cin, k) with k odd; b: (Cout,);
    residual: (B, Cout, T) or None.  Returns (B, Cout, T), differentiable in
    x, w, b and residual on both devices."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrf_conv: no kernel for device {x.device}")
    return _MRFConv.apply(x, w, b, int(dilation), residual)


mrf_conv.launches = 0
mrf_conv_bwd_data.launches = 0
mrf_conv_bwd_weight.launches = 0
