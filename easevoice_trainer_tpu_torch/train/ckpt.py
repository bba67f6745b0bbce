"""Checkpoint IO: torch .pth interop and the flax -> torch export rules.

The ecosystem's pretrained weights (GPT-SoVITS s2G/s2D/s1) and the
reference's deployable export format are torch pickles with
``{"weight": state_dict, "config": ..., "info": ...}`` semantics
(reference: src/utils/path/ckpt.py:70-97, src/train/sovits.py:179-196,
src/train/gpt.py:78-91).  This module reads and writes those pickles and
turns flax-layout parameter trees (nested dicts of numpy arrays, as the JAX
package holds them) into torch state dicts, so that

* ``convert.py`` can hand JAX parameters to the port's modules, and
* weights exported here load in reference inference.

The key rules, written torch -> flax (``flax_to_torch`` applies them
backwards):
  conv1d 1x1 (out,in,1)        -> Dense kernel (in,out)
  conv1d     (out,in,k)        -> Conv kernel (k,in,out)
  weight-normed conv           -> wn/{g: squeeze, v: transposed like above}
  conv_transpose1d (in,out,k)  -> wn/v (k,out,in), g (in,)
  linear (out,in)              -> Dense kernel (in,out)
  embedding / LayerNorm gamma,beta -> embedding / {scale,bias}
Weight-normed convs are exported with the old-style weight_g/weight_v key
spelling.

(The port's copy of the torch IO, the name rules and the GPT loader and
exporter of the JAX package's ``train/ckpt.py``: ``torch_to_flax`` reads a
reference checkpoint into a flax-layout tree and ``flax_to_torch`` writes
one back, so ``load_gpt_pretrained`` / ``export_gpt_weights`` keep the JAX
package's formats.  The SoVITS loaders stay there.)
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# low-level torch IO (host-side only; torch-cpu)
# ---------------------------------------------------------------------------


def _torch():
    import torch

    return torch


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth/.ckpt into a flat {name: float32 ndarray} dict.

    Accepts raw state dicts, trainer dicts ({"model": ...}), deployable dicts
    ({"weight": ...}) and lightning dicts ({"state_dict": ...}).
    """
    torch = _torch()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("weight", "model", "state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    flat = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            flat[k] = v.detach().to(torch.float32).cpu().numpy()
    return flat


def save_torch_state(flat: Dict[str, np.ndarray], path: str,
                     wrapper: Optional[Callable[[dict], dict]] = None,
                     half: bool = False) -> None:
    """Write a torch .pth (atomically: tmp file + move, like the reference)."""
    torch = _torch()
    sd = {}
    for k, v in flat.items():
        t = torch.from_numpy(np.asarray(v))
        sd[k] = t.half() if (half and t.is_floating_point()) else t
    obj = wrapper(sd) if wrapper else sd
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    torch.save(obj, tmp)
    shutil.move(tmp, path)


# ---------------------------------------------------------------------------
# tree <-> flat helpers
# ---------------------------------------------------------------------------


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out



def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root

# ---------------------------------------------------------------------------
# name translation: torch state dict <-> flax flat paths
# ---------------------------------------------------------------------------


_WN_G_KEYS = ("weight_g", "parametrizations.weight.original0")
_WN_V_KEYS = ("weight_v", "parametrizations.weight.original1")


def _norm_wn(tkey: str) -> str:
    for g in _WN_G_KEYS:
        if tkey.endswith(g):
            return tkey[: -len(g)] + "weight_g"
    for v in _WN_V_KEYS:
        if tkey.endswith(v):
            return tkey[: -len(v)] + "weight_v"
    return tkey


# per-tensor converters ------------------------------------------------------

def t2f_dense(w):       # (out,in) or (out,in,1) -> (in,out)
    if w.ndim == 3:
        w = w[:, :, 0]
    return np.ascontiguousarray(w.T)


def f2t_dense1x1(k):    # (in,out) -> (out,in,1)
    return np.ascontiguousarray(k.T)[:, :, None]


def f2t_linear(k):      # (in,out) -> (out,in)
    return np.ascontiguousarray(k.T)


def t2f_conv(w):        # (out,in,k) -> (k,in,out)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def f2t_conv(k):        # (k,in,out) -> (out,in,k)
    return np.ascontiguousarray(k.transpose(2, 1, 0))


def t2f_convT(w):       # transposed conv (in,out,k) -> (k,out,in)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def f2t_convT(k):       # (k,out,in) -> (in,out,k)
    return np.ascontiguousarray(k.transpose(2, 1, 0))


def t2f_conv2d(w):      # (out,in,kh,kw) -> (kh,kw,in,out)
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def f2t_conv2d(k):      # (kh,kw,in,out) -> (out,in,kh,kw)
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _squeeze_g(g):
    return np.ascontiguousarray(g.reshape(-1))


class Rule:
    """One bidirectional key rule: torch regex <-> flax template."""

    def __init__(self, torch_pat: str, flax_tpl: str, t2f, f2t,
                 tshape=None):
        self.torch_re = re.compile("^" + torch_pat + "$")
        self.flax_tpl = flax_tpl
        self.t2f = t2f
        self.f2t = f2t
        self.tshape = tshape  # fn(flax_array) -> torch shape, for g expansion

    def try_torch(self, key: str, value):
        m = self.torch_re.match(key)
        if not m:
            return None
        return self.flax_tpl.format(*m.groups()), self.t2f(value)


def _expand2(g):  # (C,) -> (C,1,1) for conv1d weight_g
    return np.ascontiguousarray(g.reshape(-1, 1, 1))


def _expand3(g):  # (C,) -> (C,1,1,1) for conv2d weight_g
    return np.ascontiguousarray(g.reshape(-1, 1, 1, 1))


def _wn_rules(tprefix: str, fprefix: str, transposed: bool = False,
              conv2d: bool = False):
    """Rules for one torch weight-normed conv -> flax wn/{g,v} + bias."""
    if conv2d:
        t2f_v, f2t_v, exp = t2f_conv2d, f2t_conv2d, _expand3
    elif transposed:
        t2f_v, f2t_v, exp = t2f_convT, f2t_convT, _expand2
    else:
        t2f_v, f2t_v, exp = t2f_conv, f2t_conv, _expand2
    return [
        Rule(tprefix + r"\.weight_g", fprefix + "/wn/g", _squeeze_g, exp),
        Rule(tprefix + r"\.weight_v", fprefix + "/wn/v", t2f_v, f2t_v),
        Rule(tprefix + r"\.bias", fprefix + "/bias", lambda x: x, lambda x: x),
    ]


def _id_rule(t, f):
    return [Rule(t, f, lambda x: x, lambda x: x)]


def _dense_rules(t, f):
    return [
        Rule(t + r"\.weight", f + "/kernel", t2f_dense, f2t_linear),
        Rule(t + r"\.bias", f + "/bias", lambda x: x, lambda x: x),
    ]


def _dense_rules_conv1x1(t, f):
    """torch 1x1 conv <-> flax Dense (export restores the trailing k dim)."""
    return [
        Rule(t + r"\.weight", f + "/kernel", t2f_dense, f2t_dense1x1),
        Rule(t + r"\.bias", f + "/bias", lambda x: x, lambda x: x),
    ]


def _conv_rules(t, f, bias=True):
    rules = [Rule(t + r"\.weight", f + "/kernel", t2f_conv, f2t_conv)]
    if bias:
        rules.append(Rule(t + r"\.bias", f + "/bias",
                          lambda x: x, lambda x: x))
    return rules


def _attention_rules(t, f):
    """Reference 1x1-conv MHA -> flax DenseGeneral q/k/v/out."""
    rules = []
    for tname, fname in (("conv_q", "query"), ("conv_k", "key"),
                         ("conv_v", "value"), ("conv_o", "out")):
        rules += _dense_rules_conv1x1(rf"{t}\.{tname}", f"{f}/{fname}")
    rules += _id_rule(rf"{t}\.emb_rel_k", f"{f}/emb_rel_k")
    rules += _id_rule(rf"{t}\.emb_rel_v", f"{f}/emb_rel_v")
    return rules


def _encoder_rules(t, f):
    """attentions.Encoder -> RelPosEncoder."""
    rules = _attention_rules(rf"{t}\.attn_layers\.(\d+)", f + "/attn_{0}")
    rules += [
        Rule(rf"{t}\.norm_layers_1\.(\d+)\.gamma", f + "/norm1_{0}/scale",
             lambda x: x, lambda x: x),
        Rule(rf"{t}\.norm_layers_1\.(\d+)\.beta", f + "/norm1_{0}/bias",
             lambda x: x, lambda x: x),
        Rule(rf"{t}\.norm_layers_2\.(\d+)\.gamma", f + "/norm2_{0}/scale",
             lambda x: x, lambda x: x),
        Rule(rf"{t}\.norm_layers_2\.(\d+)\.beta", f + "/norm2_{0}/bias",
             lambda x: x, lambda x: x),
    ]
    rules += _conv_rules(rf"{t}\.ffn_layers\.(\d+)\.conv_1", f + "/ffn_{0}/conv1")
    rules += _conv_rules(rf"{t}\.ffn_layers\.(\d+)\.conv_2", f + "/ffn_{0}/conv2")
    return rules


def _wavenet_rules(t, f):
    rules = _wn_rules(rf"{t}\.cond_layer", f + "/cond_layer")
    rules += _wn_rules(rf"{t}\.in_layers\.(\d+)", f + "/in_{0}")
    rules += _wn_rules(rf"{t}\.res_skip_layers\.(\d+)", f + "/res_skip_{0}")
    return rules


def sovits_generator_rules():
    """SynthesizerTrn state dict <-> flax params (models.py:803-1018)."""
    rules = []
    # enc_p
    rules += _dense_rules_conv1x1(r"enc_p\.ssl_proj", "enc_p/ssl_proj")
    rules += _encoder_rules(r"enc_p\.encoder_ssl", "enc_p/encoder_ssl")
    rules += _encoder_rules(r"enc_p\.encoder_text", "enc_p/encoder_text")
    rules += _encoder_rules(r"enc_p\.encoder2", "enc_p/encoder2")
    rules += _id_rule(r"enc_p\.text_embedding\.weight",
                      "enc_p/text_embedding/embedding")
    rules += _attention_rules(r"enc_p\.mrte\.cross_attention",
                              "enc_p/mrte/cross_attention")
    rules += _dense_rules_conv1x1(r"enc_p\.mrte\.c_pre", "enc_p/mrte/c_pre")
    rules += _dense_rules_conv1x1(r"enc_p\.mrte\.text_pre", "enc_p/mrte/text_pre")
    rules += _dense_rules_conv1x1(r"enc_p\.mrte\.c_post", "enc_p/mrte/c_post")
    rules += _dense_rules_conv1x1(r"enc_p\.proj", "enc_p/proj")
    # enc_q
    rules += _dense_rules_conv1x1(r"enc_q\.pre", "enc_q/pre")
    rules += _wavenet_rules(r"enc_q\.enc", "enc_q/enc")
    rules += _dense_rules_conv1x1(r"enc_q\.proj", "enc_q/proj")
    # flow: torch indices 0,2,4,6 -> coupling_0..3
    for i in range(4):
        t = rf"flow\.flows\.{2 * i}"
        f = f"flow/coupling_{i}"
        rules += _dense_rules_conv1x1(t + r"\.pre", f + "/pre")
        rules += _dense_rules_conv1x1(t + r"\.post", f + "/post")
        rules += _wavenet_rules(t + r"\.enc", f + "/enc")
    # ref_enc (MelStyleEncoder)
    rules += _dense_rules(r"ref_enc\.spectral\.0\.fc", "ref_enc/spectral1")
    rules += _dense_rules(r"ref_enc\.spectral\.3\.fc", "ref_enc/spectral2")
    rules += _conv_rules(r"ref_enc\.temporal\.0\.conv1\.conv", "ref_enc/glu1/Conv_0")
    rules += _conv_rules(r"ref_enc\.temporal\.1\.conv1\.conv", "ref_enc/glu2/Conv_0")
    for tn, fn_ in (("w_qs", "w_qs"), ("w_ks", "w_ks"), ("w_vs", "w_vs"),
                    ("fc", "fc_attn")):
        rules += _dense_rules(rf"ref_enc\.slf_attn\.{tn}", f"ref_enc/{fn_}")
    rules += _dense_rules(r"ref_enc\.fc\.fc", "ref_enc/fc_out")
    # dec (HiFi-GAN)
    rules += _conv_rules(r"dec\.conv_pre", "dec/conv_pre")
    rules += _dense_rules_conv1x1(r"dec\.cond", "dec/cond")
    rules += _wn_rules(r"dec\.ups\.(\d+)", "dec/up_{0}", transposed=True)
    # resblocks: torch flat index n = 3*i + j
    for n in range(15):
        i, j = divmod(n, 3)
        for m in range(3):
            rules += _wn_rules(rf"dec\.resblocks\.{n}\.convs1\.{m}",
                               f"dec/resblock_{i}_{j}/conv1_{m}")
            rules += _wn_rules(rf"dec\.resblocks\.{n}\.convs2\.{m}",
                               f"dec/resblock_{i}_{j}/conv2_{m}")
    rules += _conv_rules(r"dec\.conv_post", "dec/conv_post", bias=False)
    # top-level ssl_proj (k=2 s=2 conv) + quantizer
    rules += _conv_rules(r"ssl_proj", "ssl_proj")
    rules += [Rule(r"quantizer\.vq\.layers\.(\d+)\._codebook\.embed",
                   "quantizer/codebooks/{0}",
                   lambda x: x, lambda x: x)]
    return rules


def sovits_discriminator_rules(periods=(2, 3, 5, 7, 11)):
    rules = []
    # discriminators.0 = scale
    rules += sum((_wn_rules(rf"discriminators\.0\.convs\.{i}",
                            f"disc_s/conv_{i}") for i in range(6)), [])
    rules += _wn_rules(r"discriminators\.0\.conv_post", "disc_s/conv_post")
    for idx, p in enumerate(periods, start=1):
        for i in range(5):
            rules += _wn_rules(rf"discriminators\.{idx}\.convs\.{i}",
                               f"disc_p{p}/conv_{i}", conv2d=True)
        rules += _wn_rules(rf"discriminators\.{idx}\.conv_post",
                           f"disc_p{p}/conv_post", conv2d=True)
    return rules


def gpt_rules():
    """Text2SemanticDecoder (t2s_model.py:255+) <-> flax params.

    Torch keys may carry the lightning "model." prefix; it is stripped first.
    """
    rules = []
    rules += _dense_rules(r"bert_proj", "bert_proj")
    rules += _id_rule(r"ar_text_embedding\.word_embeddings\.weight",
                      "ar_text_embedding/embedding")
    rules += _id_rule(r"ar_audio_embedding\.word_embeddings\.weight",
                      "ar_audio_embedding/embedding")
    rules += _id_rule(r"ar_text_position\.alpha", "ar_text_position/alpha")
    rules += _id_rule(r"ar_audio_position\.alpha", "ar_audio_position/alpha")
    rules += [
        Rule(r"h\.layers\.(\d+)\.self_attn\.in_proj_weight",
             "layer_{0}/qkv/kernel", t2f_dense, f2t_linear),
        Rule(r"h\.layers\.(\d+)\.self_attn\.in_proj_bias",
             "layer_{0}/qkv/bias", lambda x: x, lambda x: x),
    ]
    rules += _dense_rules(r"h\.layers\.(\d+)\.self_attn\.out_proj",
                          "layer_{0}/out")
    rules += _dense_rules(r"h\.layers\.(\d+)\.linear1", "layer_{0}/linear1")
    rules += _dense_rules(r"h\.layers\.(\d+)\.linear2", "layer_{0}/linear2")
    for n in (1, 2):
        rules += [
            Rule(rf"h\.layers\.(\d+)\.norm{n}\.weight",
                 "layer_{0}/norm%d/scale" % n, lambda x: x, lambda x: x),
            Rule(rf"h\.layers\.(\d+)\.norm{n}\.bias",
                 "layer_{0}/norm%d/bias" % n, lambda x: x, lambda x: x),
        ]
    rules += [Rule(r"ar_predict_layer\.weight", "ar_predict_layer/kernel",
                   t2f_dense, f2t_linear)]
    return rules


# ---------------------------------------------------------------------------
# conversion drivers
# ---------------------------------------------------------------------------


def torch_to_flax(torch_state: Dict[str, np.ndarray], rules,
                  strip_prefixes=("model.", "module."),
                  strict: bool = False) -> Tuple[Dict[str, Any], list]:
    """Apply rules; returns (params tree, list of unmatched torch keys)."""
    flat: Dict[str, np.ndarray] = {}
    unmatched = []
    for key, value in torch_state.items():
        k = key
        for p in strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
        k = _norm_wn(k)
        hit = None
        for rule in rules:
            hit = rule.try_torch(k, value)
            if hit is not None:
                break
        if hit is None:
            unmatched.append(key)
            continue
        fkey, arr = hit
        flat[fkey] = np.asarray(arr, np.float32)
    if strict and unmatched:
        raise KeyError(f"unmatched torch keys: {unmatched[:10]}"
                       f" (+{max(0, len(unmatched) - 10)} more)")
    tree = unflatten_tree(flat)
    # codebooks arrive as {"0": arr} -> stack to (n_q, K, D)
    q = tree.get("quantizer", {}).get("codebooks")
    if isinstance(q, dict):
        layers = [q[str(i)] for i in range(len(q))]
        tree["quantizer"]["codebooks"] = np.stack(layers, axis=0)
    return tree, unmatched


def flax_to_torch(params: Dict[str, Any], rules) -> Dict[str, np.ndarray]:
    """Inverse conversion for export (reference-loadable names)."""
    flat = flatten_tree(params)
    # split codebooks back into per-layer entries
    if "quantizer/codebooks" in flat:
        cb = flat.pop("quantizer/codebooks")
        for i in range(cb.shape[0]):
            flat[f"quantizer/codebooks/{i}"] = cb[i]
    out = {}
    for fkey, value in flat.items():
        matched = False
        for rule in rules:
            # invert the template: build a regex from flax_tpl
            tpl_re = re.escape(rule.flax_tpl).replace(r"\{0\}", r"(\d+)")
            m = re.fullmatch(tpl_re, fkey)
            if not m:
                continue
            tkey = rule.torch_re.pattern[1:-1]
            for g in m.groups():
                tkey = tkey.replace(r"(\d+)", g, 1)
            tkey = tkey.replace("\\", "")
            out[tkey] = np.asarray(rule.f2t(value), np.float32)
            matched = True
            break
        if not matched:
            raise KeyError(f"no export rule for flax param {fkey}")
    return out


# ---------------------------------------------------------------------------
# high-level API
# ---------------------------------------------------------------------------


def load_gpt_pretrained(path: str):
    state = load_torch_state(path)
    return torch_to_flax(state, gpt_rules())


def export_gpt_weights(params, path: str, config: Any = None,
                       info: str = "", half: bool = True) -> None:
    flat = flax_to_torch(params, gpt_rules())
    save_torch_state(
        flat, path,
        wrapper=lambda sd: {"weight": {"model." + k: v for k, v in sd.items()},
                            "config": config, "info": info},
        half=half)
