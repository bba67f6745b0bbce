"""Plain PyTorch reference of the s1 GPT fine-tune (GPT-SoVITS s1,
``AR/models/t2s_model.py`` and ``AR/modules/optim.py``): the training
forward with its CE-sum loss, and ScaledAdam.

fp32 throughout with TF32 off, dense attention under the hybrid mask, no
kernels, no cache.  Parameters are a dict under the published state-dict
names.  It imports nothing of the program.

``lowp`` (a ``Lowp``) rounds every product's operands and the gradients
flowing into them to a lower precision: the control that a lower precision
than the configuration's must fail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    d, f, v = cfg["hidden_dim"], cfg["linear_units"], cfg["vocab_size"]
    e = cfg["embedding_dim"]
    shapes = {
        "bert_proj.weight": (e, 1024), "bert_proj.bias": (e,),
        "ar_text_embedding.word_embeddings.weight":
            (cfg["phoneme_vocab_size"], e),
        "ar_audio_embedding.word_embeddings.weight": (v, e),
        "ar_text_position.alpha": (1,), "ar_audio_position.alpha": (1,),
        "ar_predict_layer.weight": (v, d),
    }
    for i in range(cfg["n_layer"]):
        p = f"h.layers.{i}."
        shapes.update({
            p + "self_attn.in_proj_weight": (3 * d, d),
            p + "self_attn.in_proj_bias": (3 * d,),
            p + "self_attn.out_proj.weight": (d, d),
            p + "self_attn.out_proj.bias": (d,),
            p + "linear1.weight": (f, d), p + "linear1.bias": (f,),
            p + "linear2.weight": (d, f), p + "linear2.bias": (d,),
            p + "norm1.weight": (d,), p + "norm1.bias": (d,),
            p + "norm2.weight": (d,), p + "norm2.bias": (d,),
        })
    return shapes


def init_rule(name: str, shape):
    """The benchmark's draw of a weight: the common rule, with every matrix
    but the embeddings at PyTorch's default for ``nn.Linear``, which the
    upstream model starts from (uniform in +-1 / sqrt(fan-in): std
    1 / sqrt(3 fan-in)).  At the common rule's 1 / sqrt(fan-in) the 24
    post-norm layers amplify any rounding of the forward some twenty-fold
    into the gradients, so that bf16 and fp8 products read alike."""
    from evbench.common import InitRule, default_rule

    r = default_rule(name, shape)
    if len(shape) > 1 and "embedding" not in name:
        return InitRule(r.mean, r.std / math.sqrt(3.0))
    return r


class _Round(torch.autograd.Function):
    """Rounds to ``dtype`` (per-tensor scaled to its largest finite value)
    forward, and the gradient the same way backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return round_to(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.dtype), None


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in (torch.bfloat16, torch.float16):
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    scale = (x.detach().abs().amax().float() / top).clamp(min=1e-30)
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class Lowp:
    """The precision a control computes its products in (None: fp32)."""

    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dtype is None else _Round.apply(x, self.dtype)


FP32 = Lowp(None)


def sine_positions(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64,
                                 device=device) * -(math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def _linear(x, w, b, q: Lowp):
    y = q(x) @ q(w).t()
    return y if b is None else y + b


def hybrid_mask(x_len: int, y_len: int, x_lens, y_lens) -> torch.Tensor:
    """(B, 1, T, T) bool, True where a query row sees a key: text rows see
    the valid text; audio rows see the valid text and, causally, the valid
    audio."""
    t = x_len + y_len
    pos = torch.arange(t, device=x_lens.device)
    is_y = pos >= x_len
    causal = pos[None, :] <= pos[:, None]
    struct = torch.where(is_y[None, :], is_y[:, None] & causal,
                         torch.ones_like(causal))
    x_valid = pos[None, :] < x_lens[:, None]
    y_valid = is_y[None, :] & (pos[None, :] < x_len + y_lens[:, None])
    key_ok = torch.where(is_y[None, :], y_valid, x_valid)
    return (struct[None] & key_ok[:, None, :])[:, None]


def layer(P: Dict[str, torch.Tensor], i: int, h, mask, n_heads: int,
          q: Lowp):
    p = f"h.layers.{i}."
    b, t, d = h.shape
    dk = d // n_heads
    qkv = _linear(h, P[p + "self_attn.in_proj_weight"],
                  P[p + "self_attn.in_proj_bias"], q)
    qq, kk, vv = (z.reshape(b, t, n_heads, dk).transpose(1, 2)
                  for z in qkv.split(d, dim=-1))
    scores = (q(qq) @ q(kk).transpose(-1, -2)) / math.sqrt(dk)
    probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    o = (q(probs) @ q(vv)).transpose(1, 2).reshape(b, t, d)
    y = _linear(o, P[p + "self_attn.out_proj.weight"],
                P[p + "self_attn.out_proj.bias"], q)
    h = F.layer_norm(h + y, (d,), P[p + "norm1.weight"], P[p + "norm1.bias"],
                     LN_EPS)
    ffn = _linear(torch.relu(_linear(h, P[p + "linear1.weight"],
                                     P[p + "linear1.bias"], q)),
                  P[p + "linear2.weight"], P[p + "linear2.bias"], q)
    return F.layer_norm(h + ffn, (d,), P[p + "norm2.weight"],
                        P[p + "norm2.bias"], LN_EPS)


def loss(P: Dict[str, torch.Tensor], cfg: dict, x, x_lens, y, y_lens, bert,
         q: Lowp = FP32) -> torch.Tensor:
    """The CE summed over every (row, position) of the padded semantic
    stream: inputs are the codes with EOS in the pad slots, targets the
    codes shifted by one with EOS from ``len - 1`` on.

    x (B, X) phonemes, x_lens (B,), y (B, Ty) codes, y_lens (B,),
    bert (B, X, 1024)."""
    eos = cfg["EOS"]
    d = cfg["hidden_dim"]
    b, x_len = x.shape
    y_len = y.shape[1]
    pos = torch.arange(y_len, device=y.device)
    valid = pos[None, :] < y_lens[:, None]
    codes = torch.where(valid, y, torch.zeros_like(y))
    y_in = torch.where(valid, codes, torch.full_like(codes, eos))
    shifted = torch.cat([codes[:, 1:], torch.zeros_like(codes[:, :1])], 1)
    targets = torch.where(pos[None, :] + 1 < y_lens[:, None], shifted,
                          torch.full_like(shifted, eos))
    pe = sine_positions(max(x_len, y_len), d, x.device)
    tx = F.embedding(x, P["ar_text_embedding.word_embeddings.weight"]) + \
        _linear(bert, P["bert_proj.weight"], P["bert_proj.bias"], q)
    tx = tx + P["ar_text_position.alpha"] * pe[:x_len]
    ty = F.embedding(y_in, P["ar_audio_embedding.word_embeddings.weight"])
    ty = ty + P["ar_audio_position.alpha"] * pe[:y_len]
    h = torch.cat([tx, ty], 1)
    mask = hybrid_mask(x_len, y_len, x_lens, y_lens)
    for i in range(cfg["n_layer"]):
        h = layer(P, i, h, mask, cfg["head"], q)
    logits = _linear(h[:, x_len:], P["ar_predict_layer.weight"], None, q)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].sum()


def micro_batch_grads(P: Dict[str, torch.Tensor], cfg: dict, batch: dict,
                      rows: int, q: Lowp = FP32
                      ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and gradients of one micro-batch, run ``rows`` rows at a
    time (the loss is a sum over rows, so the blocks add up to it)."""
    n = batch["x"].shape[0]
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    names = list(leaves)
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        out = loss(leaves, cfg, batch["x"][sl], batch["x_lens"][sl],
                   batch["y"][sl], batch["y_lens"][sl], batch["bert"][sl], q)
        gs = torch.autograd.grad(out, [leaves[k] for k in names],
                                 allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
        total += float(out.detach())
    return total, grads


class ScaledAdam:
    """ScaledAdam (k2/icefall) per tensor, as the GPT-SoVITS s1 fine-tune
    runs it: lr 0.002, betas (0.9, 0.95), clipping_scale 2, eps 1e-8,
    size_update_period 4, fp32 state."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 0.002,
                 betas=(0.9, 0.95), eps: float = 1e-8, min_rms: float = 1e-5,
                 max_rms: float = 3.0, size_update_period: int = 4,
                 scalar_lr_scale: float = 0.1, scalar_max: float = 10.0,
                 clipping_scale: float = 2.0,
                 clipping_update_period: int = 1000):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.min_rms, self.max_rms = min_rms, max_rms
        self.K, self.scalar_lr_scale = size_update_period, scalar_lr_scale
        self.scalar_max, self.cscale = scalar_max, clipping_scale
        self.period = clipping_update_period
        self.step_count = 0
        self.norms: List[float] = []
        self.threshold = math.inf
        self.state = {}
        for k, p in params.items():
            self.state[k] = {
                "v": torch.zeros_like(p), "d": torch.zeros_like(p),
                "rms": p.pow(2).mean().sqrt() if p.numel() > 1 else None,
                "scale_v": 0.0, "scale_grads": [0.0] * self.K}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        step, K, b1, b2 = self.step_count, self.K, self.b1, self.b2
        refresh = step % K == K - 1
        tot = 0.0
        for k, p in params.items():
            sq = float((grads[k] * grads[k]).sum())
            if p.numel() > 1:
                sq *= float(self.state[k]["rms"]) ** 2
            tot += sq
        tot = math.sqrt(tot)
        self.norms.append(tot)
        if step % self.period == 0 and step > 0:
            ring = sorted(self.norms[-self.period:])
            self.threshold = self.cscale * ring[min(self.period - 1,
                                                    (self.period // 4) * 2)]
        clip = 1.0 if step < self.period else min(
            self.threshold / (tot + 1e-20), 1.0)
        bc2 = 1.0 - b2 ** (step + 1)
        do_size = refresh and step > 0
        size_lr = self.lr * self.scalar_lr_scale
        for k, p in params.items():
            g, st = grads[k], self.state[k]
            v = b2 * st["v"] + (1 - b2) * g * g
            d = b1 * st["d"]
            if p.numel() == 1:
                denom = (v / bc2).sqrt() + self.eps
                d = d - self.lr * self.scalar_lr_scale * (1 - b1) * g / denom
                new = p.clamp(-self.scalar_max, self.scalar_max) + d
            else:
                st["scale_grads"][step % K] = float((p * g).sum()) * clip
                if refresh:
                    st["rms"] = p.pow(2).mean().sqrt()
                rms = float(st["rms"])
                if do_size:
                    sg = torch.tensor(st["scale_grads"], dtype=torch.float64)
                    bk = b2 ** K
                    st["scale_v"] = bk * st["scale_v"] + (1 - bk) * float(
                        (sg * sg).mean())
                    bc2s = 1.0 - bk ** ((step + 1) // K)
                    scale_step = (-size_lr * math.sqrt(bc2s) * float(sg.sum())
                                  / (math.sqrt(st["scale_v"]) + self.eps))
                    if rms < self.min_rms:
                        scale_step = 0.0
                    if rms > self.max_rms:
                        scale_step = -size_lr * K
                    d = d + (1 - b1) * scale_step * p
                vhat = v / bc2 if bc2 < 0.99 else v
                d = d - self.lr * (1 - b1) * max(rms, self.min_rms) * g / (
                    vhat.sqrt() + self.eps)
                new = p + d
            p.copy_(new)
            st["v"], st["d"] = v, d
        self.step_count = step + 1
