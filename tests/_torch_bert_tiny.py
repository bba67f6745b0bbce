"""Tiny BERT and G2PW directories shared by the ``test_torch_*`` tests of
the port's BERT features and G2PW model.  The directories are written by
``chip_smoke.py``'s own writers (the ones its Chinese phase uses at full
width on the card), here at a small width with a vocabulary holding the
characters of the test sentences."""
from __future__ import annotations

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()

ZH_SENTENCES = [
    "我们都去了北京。",
    "银行的行长今天还在重新调整数据。",
    "我觉得这种音乐很好听，大家都乐了。",
    "朝阳升起的时候，少年背着行李出发了。",
]
# every character of the test sentences and of chip_smoke's, and a few
# more, in the vocabulary (the rest of the CJK block is left out)
VOCAB_CHARS = ("".join(ZH_SENTENCES) + chip_smoke.ZH_TEXT
               + chip_smoke.ZH_MIXED + "你好世界成熟是一种明亮而不刺眼的光辉")
VOCAB = chip_smoke.bert_vocab(size=400, chars=VOCAB_CHARS)

# head width 64, as the encoders have
TINY_BERT = dict(vocab_size=len(VOCAB), hidden_size=128, num_layers=2,
                 num_heads=2, intermediate_size=256, max_position=64)
# the width at which the GPT reads BERT features (1024): 16 heads of 64
TTS_BERT = dict(vocab_size=len(VOCAB), hidden_size=1024, num_layers=2,
                num_heads=16, intermediate_size=256, max_position=128)


def write_bert_dir(root, seed=0, weights="pytorch_model.bin", **cfg_kw):
    import torch

    from easevoice_trainer_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**{**TINY_BERT, **cfg_kw})
    state = chip_smoke.write_bert_dir(
        torch, str(root), cfg, torch.Generator().manual_seed(seed), VOCAB,
        weights)
    return str(root), cfg, state


def write_g2pw_dir(root, seed=1):
    import torch

    from easevoice_trainer_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**TINY_BERT)
    state = chip_smoke.write_g2pw_dir(
        torch, str(root), cfg, torch.Generator().manual_seed(seed), VOCAB)
    return str(root), cfg, state
