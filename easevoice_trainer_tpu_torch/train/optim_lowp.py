"""AdamW with low-precision moment storage (JAX: train/optim_lowp.py).

Torch AdamW semantics: decoupled weight decay (``p -= lr * wd * p``) and eps
outside the square root, with the update written in optax's order,
``(m / c1) / (sqrt(v / c2) + eps)``, so that fp32 moments follow
``optax.adamw`` and bf16 moments the JAX package's ``scale_by_adam_lowp``.
Moments are stored in bf16 by default; ``EASEVOICE_OPT_STATE=fp32`` stores
them in fp32.  The update math runs in fp32 either way, as multi-tensor
``torch._foreach_*`` ops.  Parameters whose ``grad`` is None are skipped,
as torch's optimizers skip them.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence

import torch


def moment_dtype() -> torch.dtype:
    """bf16 by default; EASEVOICE_OPT_STATE=fp32 opts out."""
    val = os.environ.get("EASEVOICE_OPT_STATE", "bf16").strip().lower()
    return torch.float32 if val in ("fp32", "f32", "float32") \
        else torch.bfloat16


class AdamWLowp:
    """AdamW over parameter groups ``[{"params": [...], "lr_scale": s}]``.

    ``lr_fn(count)`` gives the base learning rate of the ``count``-th update
    (0 for the first), which a group multiplies by its ``lr_scale``.
    """

    def __init__(self, groups: Sequence[Dict], lr_fn: Callable[[int], float],
                 betas=(0.8, 0.99), eps: float = 1e-9,
                 weight_decay: float = 0.01, dtype: torch.dtype = None):
        self.groups = [{"params": list(g["params"]),
                        "lr_scale": float(g.get("lr_scale", 1.0))}
                       for g in groups]
        self.lr_fn = lr_fn
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.dtype = dtype if dtype is not None else moment_dtype()
        self.count = 0
        self.state: Dict[torch.nn.Parameter, Dict[str, torch.Tensor]] = {}

    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.groups for p in g["params"]]

    def zero_grad(self) -> None:
        for p in self.params():
            p.grad = None

    def _moments(self, p):
        st = self.state.get(p)
        if st is None:
            st = self.state[p] = {
                "m": torch.zeros_like(p, dtype=self.dtype),
                "v": torch.zeros_like(p, dtype=self.dtype)}
        return st["m"], st["v"]

    @torch.no_grad()
    def step(self) -> None:
        lr_base = self.lr_fn(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        f32 = self.dtype == torch.float32
        for group in self.groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad.float() for p in params]
            ms, vs = zip(*(self._moments(p) for p in params))
            m32 = list(ms) if f32 else [m.float() for m in ms]
            v32 = list(vs) if f32 else [v.float() for v in vs]
            torch._foreach_mul_(m32, self.b1)
            torch._foreach_add_(m32, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(v32, self.b2)
            torch._foreach_addcmul_(v32, grads, grads, value=1.0 - self.b2)
            denom = torch._foreach_div(v32, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m32, c1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
            torch._foreach_add_(params, upd,
                                alpha=-lr_base * group["lr_scale"])
            if not f32:
                for m, v, mm, vv in zip(ms, vs, m32, v32):
                    m.copy_(mm)
                    v.copy_(vv)

    def state_dict(self) -> Dict:
        params = self.params()
        return {"count": self.count,
                "moments": {i: self.state[p] for i, p in enumerate(params)
                            if p in self.state}}

    def load_state_dict(self, sd: Dict) -> None:
        params = self.params()
        self.count = int(sd["count"])
        self.state = {}
        for i, st in sd["moments"].items():
            p = params[int(i)]
            self.state[p] = {k: v.to(p.device, self.dtype)
                             for k, v in st.items()}
