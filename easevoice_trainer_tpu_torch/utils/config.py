"""Pretrained-model paths and switches from the environment (JAX:
utils/config.py GlobalCFG, its path fields and ``is_half``).

The same environment variables and defaults under
``paths.pretrained_root()``.  ``is_half`` (env ``is_half``, default True)
asks for bf16 compute in the two fine-tunes; as the JAX class turns it off
on its CPU platform, this one turns it off where torch sees no CUDA card
(``platform`` "cpu"), and the trainers keep fp32 on a "cpu" device whatever
it says.  The JAX class also keeps a persistent compile cache and is a
process-wide singleton; the port has no use for the cache, and reads the
environment anew on every construction, so a changed environment takes
effect without a reset hook.
"""
from __future__ import annotations

import os

import torch

from . import paths


def str2bool(v: str | bool) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "t", "yes", "y")


class GlobalCFG:
    def __init__(self) -> None:
        self.is_half: bool = str2bool(os.environ.get("is_half", "True"))
        self.platform = "cuda" if torch.cuda.is_available() else "cpu"
        if self.platform == "cpu":
            self.is_half = False
        self.is_g2pw: bool = str2bool(os.environ.get("is_g2pw", "True"))
        pretrained = paths.pretrained_root()
        self.gpt_path: str = os.environ.get(
            "gpt_path",
            os.path.join(pretrained, "gsv-v2final-pretrained",
                         "s1bert25hz-5kh-longer-epoch=12-step=369668.ckpt"),
        )
        self.bert_path: str = os.environ.get(
            "bert_path", os.path.join(pretrained, "chinese-roberta-wwm-ext-large"))
        self.cnhubert_path: str = os.environ.get(
            "cnhubert_path", os.path.join(pretrained, "chinese-hubert-base"))
        self.sovits_path: str = os.environ.get(
            "sovits_path",
            os.path.join(pretrained, "gsv-v2final-pretrained", "s2G2333k.pth"),
        )
