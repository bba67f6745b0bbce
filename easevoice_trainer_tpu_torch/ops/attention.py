"""GPT attention kernels K1 (prefill), K2 (single-token decode) and K5 (the
gradient of K1, for the s1 fine-tune), and the encoders' attention (K1 at
head width 64: BERT, G2PW's BERT, HuBERT, Whisper's encoder; at head width
32: CT-punc).

Each wrapper dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch twin (``*_reference``, written from the JAX math with a dense
additive bias); on a CUDA tensor it launches the hand-written kernel from
``csrc/`` or raises.  ``launches`` on each wrapper counts its kernel
launches (a K5 call is ``prefill_attention_bwd.launches_per_call`` = 3 of
them).

:func:`self_attention` is the training entry: the fused qkv projection in,
o out, differentiable on both devices (K1 forward and K5 backward through
one autograd Function on the card; autograd of the dense twin on the CPU).

K1 (with or without its lse) and K5 take fp32 or bf16 q / k / v; bf16 is the
s1 fine-tune under ``is_half`` and launches their bf16 instances, counted in
``launches_bf16``.  The bf16 math is the JAX package's TransformerLayer with
dtype bfloat16 (t2s.py:118-131), whose layer input, and so its ``x.dtype``,
is fp32: scores in fp32 from the bf16 q and k, the softmax in fp32, P V in
fp32 from the fp32 probabilities and the bf16 v, o rounded to bf16 (the out
projection's cast); the gradients dq, dk, dv in fp32, rounded to bf16.  A
CUDA tensor of another dtype raises; nothing is cast to reach an instance.

Dropout on the attention probabilities (the s1 fine-tune with
``T2SConfig.dropout > 0``; JAX t2s.py:128 drops the fp32 probabilities
after the softmax): ``self_attention``, ``prefill_attention_lse`` and
``prefill_attention_bwd`` take ``dropout``, an :class:`AttentionDropout`
(rate p, a host integer seed, the layer index, ``row0``, the global batch
row of batch row 0 in a data-parallel step, and ``h0``, the layer's head
of head 0 on a tensor-parallel rank).  The keep mask M of each (batch,
head, query row, key) is Philox4x32-10 of (seed, layer, row0 + b, h0 + h,
row, key) (``ops/philox.py``, ``csrc/philox.cuh``): on the card K1's
and K5's dropout instances draw it inside their loops (counted in
``launches_dropout`` / ``launches_dropout_bf16``), on the CPU the twins
take it from ``attention_keep_mask`` and apply ``where(M, P / (1 - p), 0)``
in fp32; either way K5 draws the bits K1 drew.  The row max, row sum and
lse stay the undropped softmax's.  ``dropout`` None or p = 0 launches the
instances without dropout; p = 1 gives zeros, as flax does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..nn.layers import wide
from . import build
from .philox import attention_keep_mask, keep_threshold

DK = 32  # the GPT kernels are written for the 512/16 GPT's head width
ENCODER_DK = 64  # K1's encoder instance: 1024/16 (BERT), 768/12 (G2PW, HuBERT,
#                  Whisper-small)
ENCODER_DKS = (DK, ENCODER_DK)  # the encoder route also takes CT-punc's 256/8


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


@dataclasses.dataclass(frozen=True)
class AttentionDropout:
    """Dropout on one layer's attention probabilities: rate ``p``, the
    Philox ``seed`` (a host integer, so no launch waits on the card), the
    ``layer`` index, ``row0``, the global batch row of the call's batch
    row 0 (a data-parallel rank's first row; 0 otherwise), and ``h0``, the
    layer's head that the call's head 0 is (a tensor-parallel rank's first
    head; 0 otherwise), from which K1 and K5 draw the keep mask."""

    p: float
    seed: int
    layer: int
    row0: int = 0
    h0: int = 0

    def keep_mask(self, b: int, h: int, t: int, x_len: int,
                  device) -> torch.Tensor:
        """The keep mask (b, h, t, t) bool the kernels draw."""
        return attention_keep_mask(self.seed, self.layer, b, h, t, x_len,
                                   self.p, device, self.row0, self.h0)


def _dropping(dropout: Optional[AttentionDropout]):
    """``dropout`` when it drops something, else None (p = 0)."""
    if dropout is None or dropout.p == 0.0:
        return None
    if not 0.0 < dropout.p <= 1.0:
        raise ValueError(f"attention dropout rate {dropout.p} outside [0, 1]")
    return dropout


def _twin_mask(dropout: Optional[AttentionDropout], q: torch.Tensor,
               x_len: int):
    """(keep mask, p) of ``dropout`` for the twins of q's shape, or
    (None, 0)."""
    if dropout is None:
        return None, 0.0
    b, t, h, _ = q.shape
    return dropout.keep_mask(b, h, t, x_len, q.device), dropout.p


def _dense_attention(q, k, v, bias, mask=None, p_drop: float = 0.0):
    """Dense attention; bf16 q / k / v are taken in fp32 (their products are
    exact there) and o is rounded back to their dtype.  ``mask``: the keep
    mask (B, H, T, T) of dropout at rate ``p_drop`` on the probabilities."""
    dtype = q.dtype
    q, k, v = wide(q), wide(k), wide(v)
    dk = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    probs = torch.softmax(scores + bias, dim=-1)
    if mask is not None:
        probs = torch.where(mask, probs / (1.0 - p_drop), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(dtype)


def prefill_attention_reference(q, k, v, x_len: int, x_lens, y_lens,
                                mask=None, p_drop: float = 0.0):
    """Plain twin of K1: dense scores + build_hybrid_mask_bias; with
    ``mask`` (B, H, T, T) bool, dropout at rate ``p_drop`` on the
    probabilities, ``where(mask, P / (1 - p_drop), 0)`` in fp32."""
    bias = build_hybrid_mask_bias(x_len, q.shape[1] - x_len, x_lens, y_lens)
    return _dense_attention(q, k, v, bias, mask, p_drop)


def _masked_scores(q, k, x_len: int, x_lens, y_lens) -> torch.Tensor:
    """Scaled scores under the hybrid mask, (B, H, T, T), -inf hidden."""
    bias = build_hybrid_mask_bias(x_len, q.shape[1] - x_len, x_lens, y_lens)
    scores = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k)) / \
        math.sqrt(q.shape[-1])
    return scores + bias


def prefill_attention_lse_reference(q, k, x_len: int, x_lens, y_lens):
    """Plain twin of K1's row logsumexp, (B, H, T); -inf for a row that sees
    no key."""
    return torch.logsumexp(_masked_scores(q, k, x_len, x_lens, y_lens), -1)


def prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len: int, x_lens,
                                    y_lens, mask=None, p_drop: float = 0.0):
    """Plain twin of K5, written from the math of the softmax backward:
    P = exp(S - lse) (0 where the mask hides the pair or the row sees no
    key), D = rowsum(dO * O) (0 for such a row), dV = P^T dO,
    dS = P (dO V^T - D), dQ = dS K / sqrt(dk), dK = dS^T Q / sqrt(dk).
    All (B, T, H, dk).  bf16 inputs are taken in fp32 and the gradients
    rounded to their dtype, as K5's bf16 instance does.  With ``mask`` (the
    keep mask of dropout at rate ``p_drop``), P~ = where(mask, P / keep, 0)
    with keep = 1 - p_drop: dV = P~^T dO and dS = P (where(mask, dO V^T /
    keep, 0) - D); D is unchanged, since rowsum(dO * O) is rowsum(P~ dP)."""
    dtype = q.dtype
    q, k, v, o, do = (wide(z) for z in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_scores(q, k, x_len, x_lens, y_lens)
    lse = lse[..., None]
    p = torch.where(torch.isfinite(scores) & torch.isfinite(lse),
                    torch.exp(scores - lse), torch.zeros_like(scores))
    # D = rowsum(dO * O); 0 for a row that sees no key, whose o is 0 from
    # K1 and NaN from the dense twin, and whose P is 0 either way
    dsum = torch.where(torch.isfinite(lse),
                       (do * o).sum(-1).transpose(1, 2)[..., None], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    if mask is None:
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    else:
        keep = 1.0 - p_drop
        dv = torch.einsum("bhqk,bqhd->bkhd", torch.where(mask, p / keep, 0.0),
                          do)
        dp = torch.where(mask, dp / keep, 0.0)
    ds = p * (dp - dsum)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype not in (torch.float32, torch.bfloat16, torch.int32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")


def _check_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, want_dk: int = DK,
                 dtypes=(torch.float32,)) -> None:
    """q/k/v as the kernels read them: (B, T, H, dk) of one of ``dtypes``
    with head stride dk and unit stride in dk (views of the fused qkv
    projection are fine), batch and time strides in whole 16-byte units,
    16-byte aligned."""
    dk = q.shape[-1]
    if q.dtype not in dtypes or dk != want_dk:
        raise ValueError(f"{name}: needs {' or '.join(map(str, dtypes))} and "
                         f"dk={want_dk}, got {q.dtype} dk={dk}")
    unit = 16 // q.element_size()
    for z in (q, k, v):
        if (z.shape != q.shape or z.dtype != q.dtype or z.stride(2) != dk
                or z.stride(3) != 1 or z.stride(0) % unit
                or z.stride(1) % unit or z.data_ptr() % 16):
            raise ValueError(f"{name}: q/k/v must be {tuple(q.shape)} "
                             f"{q.dtype} with head stride dk, unit stride in "
                             f"dk, and 16-byte aligned rows")


# K1 and K5 have fp32 and bf16 instances (the s1 fine-tune under is_half)
GPT_DTYPES = (torch.float32, torch.bfloat16)


def _suffix(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _drop_args(dropout: Optional[AttentionDropout]):
    """The dropout entry points' trailing arguments (seed, layer, keep
    threshold, 1 - p, row0, h0); none without dropout."""
    if dropout is None:
        return ()
    return (int(dropout.seed) & 0xFFFFFFFFFFFFFFFF, int(dropout.layer),
            keep_threshold(dropout.p), 1.0 - dropout.p, int(dropout.row0),
            int(dropout.h0))


def _count(fn, dtype: torch.dtype, drop: bool, n: int) -> None:
    """Adds ``n`` launches to the counter of the instance that ran."""
    name = "launches" + ("_dropout" if drop else "") + (
        "_bf16" if dtype == torch.bfloat16 else "")
    setattr(fn, name, getattr(fn, name) + n)


def _prefill_cuda(q, k, v, x_len: int, x_lens, y_lens, with_lse: bool,
                  dropout: Optional[AttentionDropout] = None):
    """K1 on the card: o (B, T, H, dk), and the row logsumexp (B, H, T)
    when ``with_lse`` (else None, and K1 writes no lse); with ``dropout``
    (0 < p < 1) its dropout instance."""
    _check_cuda("prefill_attention", q, k, v, x_lens, y_lens)
    _check_heads("prefill_attention", q, k, v, dtypes=GPT_DTYPES)
    b, t, h, dk = q.shape
    if not 0 <= x_len <= t:
        raise ValueError(f"prefill_attention: x_len {x_len} outside [0, {t}]")
    x_lens = x_lens.to(torch.int32).contiguous()
    y_lens = y_lens.to(torch.int32).contiguous()
    o = torch.empty((b, t, h, dk), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    drop = _drop_args(dropout)
    lib = build.build()
    rc = getattr(lib, "ev_prefill_attention_" + ("dropout_" if drop else "")
                 + _suffix(q.dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), x_lens.data_ptr(), y_lens.data_ptr(),
        b, t, h, int(x_len), 1.0 / math.sqrt(dk), *drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "prefill_attention")
    _count(prefill_attention, q.dtype, bool(drop), 1)
    return o, lse


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      x_len: int, x_lens: torch.Tensor,
                      y_lens: torch.Tensor) -> torch.Tensor:
    """K1. q/k/v: (B, T, H, dk) fp32 or bf16 (strided views of the fused qkv
    output are fine); x_lens/y_lens: (B,) int32.  Returns o (B, T, H, dk)
    in q's dtype."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, x_len, x_lens, y_lens)
    return _prefill_cuda(q, k, v, x_len, x_lens, y_lens, False)[0]


def prefill_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          x_len: int, x_lens: torch.Tensor,
                          y_lens: torch.Tensor,
                          dropout: Optional[AttentionDropout] = None):
    """K1 writing its row logsumexp too: (o (B, T, H, dk), lse (B, H, T));
    the twins on the CPU.  ``dropout`` (0 <= p < 1) drops the
    probabilities; the lse is the undropped softmax's."""
    dropout = _dropping(dropout)
    if q.device.type == "cpu":
        return (prefill_attention_reference(q, k, v, x_len, x_lens, y_lens,
                                            *_twin_mask(dropout, q, x_len)),
                prefill_attention_lse_reference(q, k, x_len, x_lens, y_lens))
    return _prefill_cuda(q, k, v, x_len, x_lens, y_lens, True, dropout)


prefill_attention.launches = 0
prefill_attention.launches_bf16 = 0
prefill_attention.launches_dropout = 0
prefill_attention.launches_dropout_bf16 = 0


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_lens: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention with a key-padding mask, the encoders' (BERT,
    G2PW's BERT, HuBERT and Whisper's encoder at dk 64; CT-punc at dk 32).
    q/k/v: (B, T, H, dk) fp32 with dk 32 or 64 (views of the projections
    are fine); valid_lens: (B,) int.  Every query row of batch row b, pad
    rows included, sees the keys below ``valid_lens[b]``.  Returns o
    (B, T, H, dk).

    This is K1's hybrid mask with no audio part: with x_len = T and
    y_lens = 0, ``build_hybrid_mask_bias`` lets each row see the keys below
    x_lens[b] (its text branch; the audio branch covers no key), which is
    the JAX BERT's ``pad_bias`` (models/bert.py:88-91: 0 where
    attention_mask > 0, -inf elsewhere, added to every row's scores) when
    the mask is a prefix of ones, as a tokenizer's is, HuBERT's frame mask
    (models/cnhubert.py:212-217) and CT-punc's word mask
    (audiokit/punc_ct.py:112, ``finfo.min`` where K1 has -inf: every row
    sees at least one key, so the softmax is the same).  The JAX nets divide
    q by sqrt(dk) before the product (bert.py:50, asr_whisper.py:151,
    punc_ct.py:109); K1 scales the scores: both fp32, so they differ in
    rounding only.  A row with valid_lens 0 would give NaN in JAX and zeros
    in K1; it does not occur ([CLS] is always valid, a HuBERT clip always
    has frames, a punctuation call at least one word, Whisper's 1500
    frames are all valid).

    On the CPU the plain twin runs (``prefill_attention_reference``); on a
    CUDA tensor K1's instance of that head width launches, or this raises.
    ``launches`` counts the dk-64 launches, ``launches_dk32`` the dk-32
    ones."""
    b, t, h, dk = q.shape
    if q.device.type == "cpu":
        return prefill_attention_reference(
            q, k, v, t, valid_lens, torch.zeros_like(valid_lens))
    _check_cuda("encoder_attention", q, k, v, valid_lens)
    if dk not in ENCODER_DKS:
        raise ValueError(f"encoder_attention: K1 has instances for dk in "
                         f"{ENCODER_DKS}, got dk={dk}")
    _check_heads("encoder_attention", q, k, v, dk)
    valid_lens = valid_lens.to(torch.int32).contiguous()
    o = torch.empty((b, t, h, dk), dtype=torch.float32, device=q.device)
    rc = build.build().ev_encoder_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), valid_lens.data_ptr(), b, t, h, dk,
        1.0 / math.sqrt(dk),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "encoder_attention")
    if dk == ENCODER_DK:
        encoder_attention.launches += 1
    else:
        encoder_attention.launches_dk32 += 1
    return o


encoder_attention.launches = 0
encoder_attention.launches_dk32 = 0


def prefill_attention_bwd(q, k, v, o, lse, do, x_len: int, x_lens, y_lens,
                          out=None, dropout: Optional[AttentionDropout] = None):
    """K5, the gradient of K1: (dq, dk, dv), each (B, T, H, dk).

    q/k/v are K1's inputs (views of one fused projection sharing its
    strides), o and lse its outputs, ``do`` the gradient of o.  ``out``: the
    (dq, dk, dv) views to write, sharing one batch / time stride (the three
    slices of the fused projection's gradient); new tensors when None.  On
    the CPU the plain twin runs.  One K5 call is three launches (D, dK/dV,
    dQ), and counts three.  fp32 or bf16 (then o, do and the outputs are
    bf16, lse fp32; ``launches_bf16`` counts them).  ``dropout``: the one K1
    ran with (0 <= p < 1), whose mask K5 draws again; its instances count
    in ``launches_dropout`` / ``launches_dropout_bf16``."""
    dropout = _dropping(dropout)
    if q.device.type == "cpu":
        grads = prefill_attention_bwd_reference(
            q, k, v, o, lse, do, x_len, x_lens, y_lens,
            *_twin_mask(dropout, q, x_len))
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return out
    _check_cuda("prefill_attention_bwd", q, k, v, o, lse, do, x_lens,
                y_lens)
    _check_heads("prefill_attention_bwd", q, k, v, dtypes=GPT_DTYPES)
    if (o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32):
        raise ValueError(f"prefill_attention_bwd: o and do must be "
                         f"{q.dtype} like q, lse fp32; got {o.dtype}, "
                         f"{do.dtype}, {lse.dtype}")
    b, t, h, dk = q.shape
    if not 0 <= x_len <= t:
        raise ValueError(f"prefill_attention_bwd: x_len {x_len} outside "
                         f"[0, {t}]")
    if out is None:
        dqkv = torch.empty((b, t, 3 * h * dk), dtype=q.dtype,
                           device=q.device)
        out = [z.view(b, t, h, dk) for z in dqkv.split(h * dk, dim=-1)]
    _check_heads("prefill_attention_bwd", *out, dtypes=(q.dtype,))
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
    drop = _drop_args(dropout)
    rc = getattr(build.build(), "ev_prefill_attention_bwd_"
                 + ("dropout_" if drop else "") + _suffix(q.dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk_.data_ptr(), dv.data_ptr(), q.stride(0), q.stride(1),
        dq.stride(0), dq.stride(1), x_lens.data_ptr(), y_lens.data_ptr(),
        b, t, h, int(x_len), 1.0 / math.sqrt(dk), *drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "prefill_attention_bwd")
    _count(prefill_attention_bwd, q.dtype, bool(drop),
           prefill_attention_bwd.launches_per_call)
    return tuple(out)


prefill_attention_bwd.launches = 0
prefill_attention_bwd.launches_bf16 = 0
prefill_attention_bwd.launches_dropout = 0
prefill_attention_bwd.launches_dropout_bf16 = 0
prefill_attention_bwd.launches_per_call = 3    # dsum, dkdv, dq


def _split_heads(qkv: torch.Tensor, n_heads: int):
    b, t, three_d = qkv.shape
    d = three_d // 3
    return [z.view(b, t, n_heads, d // n_heads)
            for z in qkv.split(d, dim=-1)]


class _SelfAttention(torch.autograd.Function):
    """K1 forward (with its row logsumexp) and K5 backward; d(qkv) is one
    (B, T, 3 * D) tensor whose three slices K5 writes in place.  K5 takes
    K1's dropout, and so draws K1's mask."""

    @staticmethod
    def forward(ctx, qkv, n_heads, x_len, x_lens, y_lens, dropout):
        q, k, v = _split_heads(qkv, n_heads)
        o, lse = _prefill_cuda(q, k, v, x_len, x_lens, y_lens, True, dropout)
        ctx.save_for_backward(qkv, o, lse, x_lens, y_lens)
        ctx.n_heads, ctx.x_len, ctx.dropout = n_heads, x_len, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, x_lens, y_lens = ctx.saved_tensors
        q, k, v = _split_heads(qkv, ctx.n_heads)
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        prefill_attention_bwd(q, k, v, o, lse, do, ctx.x_len, x_lens, y_lens,
                              out=_split_heads(dqkv, ctx.n_heads),
                              dropout=ctx.dropout)
        return dqkv, None, None, None, None, None


def self_attention(qkv: torch.Tensor, n_heads: int, x_len: int,
                   x_lens: torch.Tensor, y_lens: torch.Tensor,
                   dropout: Optional[AttentionDropout] = None
                   ) -> torch.Tensor:
    """Training attention over [text; audio] under the hybrid mask.

    qkv: (B, T, 3 * D) fp32 or bf16, the fused projection (q, k, v along
    the last axis, each H heads of dk); returns o (B, T, H, dk) in qkv's
    dtype, differentiable in qkv.  On the card: K1 forward, K5 backward
    (their bf16 instances for bf16), or a raise.  On the CPU: the dense
    twin, which autograd differentiates.  ``dropout``: dropout on the
    probabilities (K1 / K5's dropout instances on the card, the twin with
    ``attention_keep_mask`` on the CPU); at p = 1, o is zeros, as flax's
    dropout at rate 1 zeroes the probabilities."""
    dropout = _dropping(dropout)
    if dropout is not None and dropout.p == 1.0:
        b, t, three_d = qkv.shape
        return qkv.new_zeros((b, t, n_heads, three_d // (3 * n_heads)))
    if qkv.device.type == "cpu":
        q, k, v = _split_heads(qkv, n_heads)
        return prefill_attention_reference(q, k, v, x_len, x_lens, y_lens,
                                           *_twin_mask(dropout, q, x_len))
    if qkv.device.type != "cuda":
        raise ValueError(f"self_attention: no kernel for device "
                         f"{qkv.device}")
    return _SelfAttention.apply(qkv, n_heads, int(x_len),
                                x_lens.to(torch.int32),
                                y_lens.to(torch.int32), dropout)


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
            and k_cache.dtype == v_cache.dtype == torch.float32
            and v_cache.shape == k_cache.shape
            and q.shape == (b, 1, h, dk)
            and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0):
        raise ValueError("decode_attention: caches must be contiguous, "
                         "16-byte aligned fp32 (B, cache_len, H, dk) "
                         "matching q")
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
