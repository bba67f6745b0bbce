"""GPT attention kernels K1 (prefill), K2 (single-token decode) and K5 (the
gradient of K1, for the s1 fine-tune), and the encoders' attention (K1 at
head width 64: BERT, G2PW's BERT, HuBERT).

Each wrapper dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch twin (``*_reference``, written from the JAX math with a dense
additive bias); on a CUDA tensor it launches the hand-written kernel from
``csrc/`` or raises.  ``launches`` on each wrapper counts its kernel
launches (a K5 call is ``prefill_attention_bwd.launches_per_call`` = 3 of
them).

:func:`self_attention` is the training entry: the fused qkv projection in,
o out, differentiable on both devices (K1 forward and K5 backward through
one autograd Function on the card; autograd of the dense twin on the CPU).
"""
from __future__ import annotations

import math

import torch

from . import build

DK = 32  # the GPT kernels are written for the 512/16 GPT's head width
ENCODER_DK = 64  # K1's encoder instance: 1024/16 (BERT), 768/12 (G2PW, HuBERT)


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


def _masked_scores(q, k, x_len: int, x_lens, y_lens) -> torch.Tensor:
    """Scaled scores under the hybrid mask, (B, H, T, T), -inf hidden."""
    bias = build_hybrid_mask_bias(x_len, q.shape[1] - x_len, x_lens, y_lens)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return scores + bias


def prefill_attention_lse_reference(q, k, x_len: int, x_lens, y_lens):
    """Plain twin of K1's row logsumexp, (B, H, T); -inf for a row that sees
    no key."""
    return torch.logsumexp(_masked_scores(q, k, x_len, x_lens, y_lens), -1)


def prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len: int, x_lens,
                                    y_lens):
    """Plain twin of K5, written from the math of the softmax backward:
    P = exp(S - lse) (0 where the mask hides the pair or the row sees no
    key), D = rowsum(dO * O) (0 for such a row), dV = P^T dO,
    dS = P (dO V^T - D), dQ = dS K / sqrt(dk), dK = dS^T Q / sqrt(dk).
    All (B, T, H, dk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_scores(q, k, x_len, x_lens, y_lens)
    lse = lse[..., None]
    p = torch.where(torch.isfinite(scores) & torch.isfinite(lse),
                    torch.exp(scores - lse), torch.zeros_like(scores))
    # D = rowsum(dO * O); 0 for a row that sees no key, whose o is 0 from
    # K1 and NaN from the dense twin, and whose P is 0 either way
    dsum = torch.where(torch.isfinite(lse),
                       (do * o).sum(-1).transpose(1, 2)[..., None], 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - dsum)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")


def _check_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, want_dk: int = DK) -> None:
    """q/k/v as the kernels read them: fp32 (B, T, H, dk) with head stride dk
    and unit stride in dk (views of the fused qkv projection are fine), batch
    and time strides in whole 16-byte units, 16-byte aligned."""
    dk = q.shape[-1]
    if q.dtype != torch.float32 or dk != want_dk:
        raise ValueError(f"{name}: needs fp32 and dk={want_dk}, got "
                         f"{q.dtype} dk={dk}")
    for z in (q, k, v):
        if (z.shape != q.shape or z.stride(2) != dk or z.stride(3) != 1
                or z.stride(0) % 4 or z.stride(1) % 4
                or z.data_ptr() % 16):
            raise ValueError(f"{name}: q/k/v must be {tuple(q.shape)} "
                             f"fp32 with head stride dk, unit stride in dk, "
                             f"and 16-byte aligned rows")


def _prefill_cuda(q, k, v, x_len: int, x_lens, y_lens, with_lse: bool):
    """K1 on the card: o (B, T, H, dk), and the row logsumexp (B, H, T)
    when ``with_lse`` (else None, and K1 writes no lse)."""
    _check_cuda("prefill_attention", q, k, v, x_lens, y_lens)
    _check_heads("prefill_attention", q, k, v)
    b, t, h, dk = q.shape
    if not 0 <= x_len <= t:
        raise ValueError(f"prefill_attention: x_len {x_len} outside [0, {t}]")
    x_lens = x_lens.to(torch.int32).contiguous()
    y_lens = y_lens.to(torch.int32).contiguous()
    o = torch.empty((b, t, h, dk), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build.build()
    rc = lib.ev_prefill_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), x_lens.data_ptr(), y_lens.data_ptr(),
        b, t, h, int(x_len), 1.0 / math.sqrt(dk),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "prefill_attention")
    prefill_attention.launches += 1
    return o, lse


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      x_len: int, x_lens: torch.Tensor,
                      y_lens: torch.Tensor) -> torch.Tensor:
    """K1. q/k/v: (B, T, H, dk) fp32 (strided views of the fused qkv output
    are fine); x_lens/y_lens: (B,) int32.  Returns o (B, T, H, dk)."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, x_len, x_lens, y_lens)
    return _prefill_cuda(q, k, v, x_len, x_lens, y_lens, False)[0]


def prefill_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          x_len: int, x_lens: torch.Tensor,
                          y_lens: torch.Tensor):
    """K1 writing its row logsumexp too: (o (B, T, H, dk), lse (B, H, T));
    the twins on the CPU."""
    if q.device.type == "cpu":
        return (prefill_attention_reference(q, k, v, x_len, x_lens, y_lens),
                prefill_attention_lse_reference(q, k, x_len, x_lens, y_lens))
    return _prefill_cuda(q, k, v, x_len, x_lens, y_lens, True)


prefill_attention.launches = 0


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_lens: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention with a key-padding mask, the encoders' (BERT,
    G2PW's BERT, HuBERT).  q/k/v: (B, T, H, 64) fp32 (views of the
    projections are fine); valid_lens: (B,) int.  Every query row of batch
    row b, pad rows included, sees the keys below ``valid_lens[b]``.
    Returns o (B, T, H, 64).

    This is K1's hybrid mask with no audio part: with x_len = T and
    y_lens = 0, ``build_hybrid_mask_bias`` lets each row see the keys below
    x_lens[b] (its text branch; the audio branch covers no key), which is
    the JAX BERT's ``pad_bias`` (models/bert.py:88-91: 0 where
    attention_mask > 0, -inf elsewhere, added to every row's scores) when
    the mask is a prefix of ones, as a tokenizer's is, and HuBERT's frame
    mask (models/cnhubert.py:212-217).  The JAX BERT divides q by sqrt(dk)
    before the product (bert.py:50); K1 scales the scores: both fp32, so
    they differ in rounding only.  A row with valid_lens 0 would give NaN
    in JAX and zeros in K1; it does not occur ([CLS] is always valid, a
    HuBERT clip always has frames).

    On the CPU the plain twin runs (``prefill_attention_reference``); on a
    CUDA tensor K1's dk-64 instance launches, or this raises."""
    b, t = q.shape[:2]
    if q.device.type == "cpu":
        return prefill_attention_reference(
            q, k, v, t, valid_lens, torch.zeros_like(valid_lens))
    _check_cuda("encoder_attention", q, k, v, valid_lens)
    _check_heads("encoder_attention", q, k, v, ENCODER_DK)
    h = q.shape[2]
    valid_lens = valid_lens.to(torch.int32).contiguous()
    o = torch.empty((b, t, h, ENCODER_DK), dtype=torch.float32,
                    device=q.device)
    rc = build.build().ev_encoder_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), valid_lens.data_ptr(), b, t, h,
        1.0 / math.sqrt(ENCODER_DK),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "encoder_attention")
    encoder_attention.launches += 1
    return o


encoder_attention.launches = 0


def prefill_attention_bwd(q, k, v, o, lse, do, x_len: int, x_lens, y_lens,
                          out=None):
    """K5, the gradient of K1: (dq, dk, dv), each (B, T, H, dk).

    q/k/v are K1's inputs (views of one fused projection sharing its
    strides), o and lse its outputs, ``do`` the gradient of o.  ``out``: the
    (dq, dk, dv) views to write, sharing one batch / time stride (the three
    slices of the fused projection's gradient); new tensors when None.  On
    the CPU the plain twin runs.  One K5 call is three launches (D, dK/dV,
    dQ), and counts three."""
    if q.device.type == "cpu":
        grads = prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len,
                                                x_lens, y_lens)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return out
    _check_cuda("prefill_attention_bwd", q, k, v, o, lse, do, x_lens,
                y_lens)
    _check_heads("prefill_attention_bwd", q, k, v)
    b, t, h, dk = q.shape
    if not 0 <= x_len <= t:
        raise ValueError(f"prefill_attention_bwd: x_len {x_len} outside "
                         f"[0, {t}]")
    if out is None:
        dqkv = torch.empty((b, t, 3 * h * dk), dtype=torch.float32,
                           device=q.device)
        out = [z.view(b, t, h, dk) for z in dqkv.split(h * dk, dim=-1)]
    _check_heads("prefill_attention_bwd", *out)
    strided = (q, k, v), tuple(out)
    if any(z.stride()[:2] != zs[0].stride()[:2] for zs in strided
           for z in zs):
        raise ValueError("prefill_attention_bwd: q/k/v, and dq/dk/dv, must "
                         "each share one batch and time stride")
    o, do = o.contiguous(), do.contiguous()
    lse = lse.contiguous()
    if (o.shape != q.shape or do.shape != q.shape
            or lse.shape != (b, h, t)
            or o.data_ptr() % 16 or do.data_ptr() % 16):
        raise ValueError("prefill_attention_bwd: o and do must be "
                         f"{tuple(q.shape)}, 16-byte aligned, lse "
                         f"{(b, h, t)}")
    x_lens = x_lens.to(torch.int32).contiguous()
    y_lens = y_lens.to(torch.int32).contiguous()
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq, dk_, dv = out
    rc = build.build().ev_prefill_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk_.data_ptr(), dv.data_ptr(), q.stride(0), q.stride(1),
        dq.stride(0), dq.stride(1), x_lens.data_ptr(), y_lens.data_ptr(),
        b, t, h, int(x_len), 1.0 / math.sqrt(dk),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "prefill_attention_bwd")
    prefill_attention_bwd.launches += prefill_attention_bwd.launches_per_call
    return tuple(out)


prefill_attention_bwd.launches = 0
prefill_attention_bwd.launches_per_call = 3    # dsum, dkdv, dq


def _split_heads(qkv: torch.Tensor, n_heads: int):
    b, t, three_d = qkv.shape
    d = three_d // 3
    return [z.view(b, t, n_heads, d // n_heads)
            for z in qkv.split(d, dim=-1)]


class _SelfAttention(torch.autograd.Function):
    """K1 forward (with its row logsumexp) and K5 backward; d(qkv) is one
    (B, T, 3 * D) tensor whose three slices K5 writes in place."""

    @staticmethod
    def forward(ctx, qkv, n_heads, x_len, x_lens, y_lens):
        q, k, v = _split_heads(qkv, n_heads)
        o, lse = _prefill_cuda(q, k, v, x_len, x_lens, y_lens, True)
        ctx.save_for_backward(qkv, o, lse, x_lens, y_lens)
        ctx.n_heads, ctx.x_len = n_heads, x_len
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, x_lens, y_lens = ctx.saved_tensors
        q, k, v = _split_heads(qkv, ctx.n_heads)
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        prefill_attention_bwd(q, k, v, o, lse, do, ctx.x_len, x_lens, y_lens,
                              out=_split_heads(dqkv, ctx.n_heads))
        return dqkv, None, None, None, None


def self_attention(qkv: torch.Tensor, n_heads: int, x_len: int,
                   x_lens: torch.Tensor, y_lens: torch.Tensor
                   ) -> torch.Tensor:
    """Training attention over [text; audio] under the hybrid mask.

    qkv: (B, T, 3 * D) fp32, the fused projection (q, k, v along the last
    axis, each H heads of dk); returns o (B, T, H, dk), differentiable in
    qkv.  On the card: K1 forward, K5 backward, or a raise.  On the CPU: the
    dense twin, which autograd differentiates."""
    if qkv.device.type == "cpu":
        q, k, v = _split_heads(qkv, n_heads)
        return prefill_attention_reference(q, k, v, x_len, x_lens, y_lens)
    if qkv.device.type != "cuda":
        raise ValueError(f"self_attention: no kernel for device "
                         f"{qkv.device}")
    return _SelfAttention.apply(qkv, n_heads, int(x_len),
                                x_lens.to(torch.int32), y_lens.to(torch.int32))


def decode_attention_reference(q, k_cache, v_cache, x_len: int, x_lens,
                               prompt_len: int, step: int):
    """Plain twin of K2's attention: dense scores over the whole cache + the
    kv bias of the decode loop (JAX: decode.py:141-156, t2s.py:366-373).
    Reads the cache after the new token's K/V were written."""
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

    q, k, v: (B, 1, H, dk) for the new token (strided views of the fused
    qkv output are fine); k_cache/v_cache: (B, cache_len, H, dk), one layer
    of the (L, B, cache_len, H, dk) stack.  The new token's K/V are written
    in place at slot ``x_len + prompt_len + step`` and the query attends to
    every valid slot, that one included.  On the CPU the twin writes first
    and then attends, as the JAX ``decode_step`` does; on the card the
    kernel does both in one launch.  Raises before writing anything when the
    slot is outside the cache.  Returns o (B, 1, H, dk).
    """
    pos = x_len + prompt_len + step
    cache_len = k_cache.shape[1]
    if not x_len <= pos < cache_len:
        raise ValueError(f"decode_attention: slot {pos} outside the cache's "
                         f"[{x_len}, {cache_len})")
    if q.device.type == "cpu":
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        return decode_attention_reference(q, k_cache, v_cache, x_len, x_lens,
                                          prompt_len, step)
    _check_cuda("decode_attention", q, k, v, k_cache, v_cache, x_lens)
    b, _, h, dk = k_cache.shape
    _check_heads("decode_attention", q, k, v)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()
            and v_cache.shape == k_cache.shape
            and q.shape == (b, 1, h, dk)
            and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0):
        raise ValueError("decode_attention: caches must be contiguous, "
                         "16-byte aligned (B, cache_len, H, dk) matching q")
    x_lens = x_lens.to(torch.int32).contiguous()
    o = torch.empty((b, 1, h, dk), dtype=torch.float32, device=q.device)
    lib = build.build()
    rc = lib.ev_decode_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), o.data_ptr(), x_lens.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0), b, h, cache_len, int(x_len),
        pos, 1.0 / math.sqrt(dk),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
