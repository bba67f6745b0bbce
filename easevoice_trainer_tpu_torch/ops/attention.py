"""GPT attention kernels K1 (prefill) and K2 (single-token decode).

Each wrapper dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch twin (``*_reference``, written from the JAX math with a dense
additive bias); on a CUDA tensor it launches the hand-written kernel from
``csrc/`` or raises.  ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import build

DK = 32  # the kernels are written for the 512/16 GPT's head width


def build_hybrid_mask_bias(x_len: int, y_len: int, x_lens: torch.Tensor,
                           y_lens: torch.Tensor) -> torch.Tensor:
    """Additive bias for the concatenated [x; y] sequence, (B, 1, T, T).

    Text rows attend to valid text only; audio rows attend to valid text and
    causally to valid audio; hidden entries are -inf
    (JAX: models/gpt/t2s.py:173-199).
    """
    t = x_len + y_len
    pos = torch.arange(t, device=x_lens.device)
    is_y = pos >= x_len
    causal = pos[None, :] <= pos[:, None]
    struct_ok = torch.where(is_y[None, :], is_y[:, None] & causal,
                            torch.ones_like(causal))
    x_valid = pos[None, :] < x_lens[:, None]
    y_valid = is_y[None, :] & (pos[None, :] < x_len + y_lens[:, None])
    key_ok = torch.where(is_y[None, :], y_valid, x_valid)
    ok = struct_ok[None] & key_ok[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x_lens.device)
    return torch.where(ok, zero, -math.inf)[:, None]


def _dense_attention(q, k, v, bias):
    dk = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def prefill_attention_reference(q, k, v, x_len: int, x_lens, y_lens):
    """Plain twin of K1: dense scores + build_hybrid_mask_bias."""
    bias = build_hybrid_mask_bias(x_len, q.shape[1] - x_len, x_lens, y_lens)
    return _dense_attention(q, k, v, bias)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      x_len: int, x_lens: torch.Tensor,
                      y_lens: torch.Tensor) -> torch.Tensor:
    """K1. q/k/v: (B, T, H, dk) fp32 (strided views of the fused qkv output
    are fine); x_lens/y_lens: (B,) int32.  Returns o (B, T, H, dk)."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, x_len, x_lens, y_lens)
    _check_cuda("prefill_attention", q, k, v, x_lens, y_lens)
    b, t, h, dk = q.shape
    if q.dtype != torch.float32 or dk != DK:
        raise ValueError(f"prefill_attention: needs fp32 and dk={DK}, got "
                         f"{q.dtype} dk={dk}")
    for z in (q, k, v):
        if z.shape != q.shape or z.stride(2) != DK or z.stride(3) != 1:
            raise ValueError("prefill_attention: q/k/v must be (B, T, H, dk) "
                             "with unit stride in dk and head stride dk")
    x_lens = x_lens.to(torch.int32).contiguous()
    y_lens = y_lens.to(torch.int32).contiguous()
    o = torch.empty((b, t, h, dk), dtype=torch.float32, device=q.device)
    lib = build.build()
    rc = lib.ev_prefill_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        x_lens.data_ptr(), y_lens.data_ptr(), b, t, h, int(x_len),
        1.0 / math.sqrt(dk), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "prefill_attention")
    prefill_attention.launches += 1
    return o


prefill_attention.launches = 0


def decode_attention_reference(q, k_cache, v_cache, x_len: int, x_lens,
                               prompt_len: int, step: int):
    """Plain twin of K2: dense scores over the whole cache + the kv bias of
    the decode loop (JAX: decode.py:141-156, t2s.py:366-373)."""
    # valid: text slots below x_lens[b] (the pads sit in the middle of the
    # cache), then every slot in [x_len, x_len + prompt_len + step]
    kv_end = x_len + prompt_len + step + 1
    slot = torch.arange(k_cache.shape[1], device=q.device)
    ok = (slot[None, :] < x_lens[:, None]) | (
        (slot[None, :] >= x_len) & (slot[None, :] < kv_end))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, -math.inf)[:, None, None, :]
    return _dense_attention(q, k_cache, v_cache, bias)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     x_len: int, x_lens: torch.Tensor, prompt_len: int,
                     step: int) -> torch.Tensor:
    """K2. One decode step of one layer.

    q, k, v: (B, 1, H, dk) for the new token; k_cache/v_cache:
    (B, cache_len, H, dk), one layer of the (L, B, cache_len, H, dk) stack.
    The new token's K/V are written in place at slot
    ``x_len + prompt_len + step`` first, then the query attends to every
    valid slot.  Returns o (B, 1, H, dk).
    """
    pos = x_len + prompt_len + step
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, x_len, x_lens,
                                          prompt_len, step)
    _check_cuda("decode_attention", q, k_cache, v_cache, x_lens)
    b, cache_len, h, dk = k_cache.shape
    if k_cache.dtype != torch.float32 or dk != DK:
        raise ValueError(f"decode_attention: needs fp32 and dk={DK}, got "
                         f"{k_cache.dtype} dk={dk}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()
            and v_cache.shape == k_cache.shape
            and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0):
        raise ValueError("decode_attention: caches must be contiguous, "
                         "16-byte aligned (B, cache_len, H, dk)")
    if pos >= cache_len:
        raise ValueError(f"decode_attention: slot {pos} beyond cache "
                         f"{cache_len}")
    q = q.contiguous()
    x_lens = x_lens.to(torch.int32).contiguous()
    o = torch.empty((b, 1, h, dk), dtype=torch.float32, device=q.device)
    lib = build.build()
    rc = lib.ev_decode_attention_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        x_lens.data_ptr(), b, h, cache_len, int(x_len), pos + 1,
        1.0 / math.sqrt(dk), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
