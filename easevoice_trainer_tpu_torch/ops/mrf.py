"""K3: the leaky-relu -> dilated conv -> bias (+ residual) step of the
HiFi-GAN MRF ResBlocks.

``mrf_conv`` dispatches on the device of ``x``: on the CPU it runs the plain
twin (``F.conv1d`` on the activated input); on a CUDA tensor it launches the
hand-written kernel ``csrc/mrf_conv.cu`` or raises.  ``mrf_conv.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..nn.layers import LRELU_SLOPE
from . import build


def mrf_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int,
                       residual: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain twin: conv1d(leaky_relu(x), w, dilation, same padding) + b
    (+ residual), the JAX ResBlock math (models/sovits/generator.py:31-44)."""
    k = w.shape[-1]
    y = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w, b,
                 padding=(k - 1) * dilation // 2, dilation=dilation)
    return y if residual is None else y + residual


def mrf_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dilation: int,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, Cin, T) fp32; w: (Cout, Cin, k) with k odd; b: (Cout,);
    residual: (B, Cout, T) or None.  Returns (B, Cout, T)."""
    if x.device.type == "cpu":
        return mrf_conv_reference(x, w, b, dilation, residual)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_conv: no kernel for device {x.device}")
    tensors = [x, w, b] + ([residual] if residual is not None else [])
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("mrf_conv: all tensors must be fp32 on one CUDA "
                             "device")
    bsz, cin, t_len = x.shape
    cout, cin_w, k = w.shape
    if cin_w != cin or k % 2 == 0 or b.shape != (cout,):
        raise ValueError(f"mrf_conv: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} b{tuple(b.shape)}")
    if residual is not None and residual.shape != (bsz, cout, t_len):
        raise ValueError("mrf_conv: residual must be (B, Cout, T)")
    x = x.contiguous()
    w = w.contiguous()
    b = b.contiguous()
    residual = residual.contiguous() if residual is not None else None
    y = torch.empty((bsz, cout, t_len), dtype=torch.float32, device=x.device)
    lib = build.build()
    rc = lib.ev_mrf_conv_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        bsz, cin, cout, t_len, k, int(dilation), LRELU_SLOPE,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "mrf_conv")
    mrf_conv.launches += 1
    return y


mrf_conv.launches = 0
