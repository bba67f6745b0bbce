"""JAX parameter trees (as numpy) -> state dicts of the port's modules.

SoVITS, its discriminators and GPT go through the checkpoint name rules of
``train/ckpt.py`` (the port's copy of the JAX package's torch-export rules:
``flax_to_torch`` with ``sovits_generator_rules`` /
``sovits_discriminator_rules`` / ``gpt_rules``), so the names are the
reference torch names.  HuBERT goes through a numpy inverse of the JAX package's
``convert_hf_hubert``, giving HF ``HubertModel`` names, and BERT through the
inverse of ``models/bert.py`` ``convert_hf_bert``, giving HF ``BertModel``
names.  The ASR nets go through inverses of the JAX package's four ASR
converters: Paraformer and CT-punc to FunASR's names, the fsmn-VAD to
FunASR's FSMN encoder names, Whisper to HF's.  Each result loads with
``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from .nn.layers import weight_norm_key
from .train import ckpt


@torch.no_grad()
def random_state_dict(module: torch.nn.Module, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every state-dict entry of ``module``, on the
    generator's device, at scales that keep activations bounded:

    * matrices, conv kernels and embeddings: U(-a, a), a = 1/sqrt(fan_in);
    * norm scales: 1 + U(-0.1, 0.1); biases and other vectors: U(-0.1, 0.1);
      positional ``alpha``: 1;
    * weight-norm ``weight_g``: the norm of its ``weight_v`` (folded weight
      = ``weight_v``);
    * quantizer codebooks: U(-1, 1).
    """
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator, device=dev) * 2 - 1) \
            * bound

    for name, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        if name.endswith("weight_g"):
            continue
        if name.endswith("alpha"):
            t = torch.ones(shape, device=dev)
        elif name.endswith("_codebook.embed"):
            t = uniform(shape, 1.0)
        elif name.endswith("gamma") or (len(shape) == 1
                                        and "norm" in name.lower()
                                        and name.endswith("weight")):
            t = 1.0 + uniform(shape, 0.1)
        elif len(shape) <= 1:
            t = uniform(shape, 0.1)
        else:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            t = uniform(shape, 1.0 / fan_in ** 0.5)
        out[name] = t
    for name, ref in module.state_dict().items():
        if name.endswith("weight_g"):
            v = out[name[:-1] + "v"]
            dims = [d for d, s in enumerate(ref.shape) if s == 1]
            out[name] = torch.linalg.vector_norm(v, dim=dims, keepdim=True)
    return out


def load_torch_state_dict(path: str, drop_prefix: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Read a .pth/.ckpt as the port's state-dict names: wrapper dicts
    unwrapped, ``model.``/``module.`` prefixes and the parametrized
    weight-norm spelling normalized, ``drop_prefix`` entries removed."""
    out = {}
    for key, value in ckpt.load_torch_state(path).items():
        for p in ("model.", "module."):
            if key.startswith(p):
                key = key[len(p):]
        key = weight_norm_key(key)
        if drop_prefix and key.startswith(drop_prefix):
            continue
        out[key] = torch.from_numpy(value)
    return out


def _to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flat.items()}


def sovits_state_dict(params: Dict[str, Any], keep_enc_q: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """SynthesizerTrn params -> the port's SynthesizerTrn state dict.  The
    posterior encoder ``enc_q`` is training-only: it is dropped for the
    inference build and kept (``keep_enc_q``) for ``with_enc_q=True``."""
    if not keep_enc_q:
        params = {k: v for k, v in params.items() if k != "enc_q"}
    return _to_torch(ckpt.flax_to_torch(params, ckpt.sovits_generator_rules()))


def discriminator_state_dict(params: Dict[str, Any],
                             periods=(2, 3, 5, 7, 11)
                             ) -> Dict[str, torch.Tensor]:
    """MultiPeriodDiscriminator params -> the port's state dict (reference
    names ``discriminators.{i}.convs.{j}``)."""
    return _to_torch(ckpt.flax_to_torch(
        params, ckpt.sovits_discriminator_rules(periods)))


def gpt_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Text2SemanticDecoder params -> the port's state dict."""
    return _to_torch(ckpt.flax_to_torch(params, ckpt.gpt_rules()))


def hubert_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """CNHubert params -> HF HubertModel names (inverse of the JAX package's
    ``models/cnhubert.py`` ``convert_hf_hubert``).

    The positional conv is weight-normed per kernel tap in HF (dim=2); its
    dense kernel is rebuilt from the JAX (g, v) split and stored as
    ``weight_v`` with ``weight_g = ||weight_v||`` per tap, which folds back
    to the same kernel.
    """
    p = {k: np.asarray(v, np.float32)
         for k, v in ckpt.flatten_tree(params).items()}
    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"feature_extractor/conv_{i}/kernel" in p:
        out[f"feature_extractor.conv_layers.{i}.conv.weight"] = \
            p[f"feature_extractor/conv_{i}/kernel"].transpose(2, 1, 0)
        i += 1
    out["feature_extractor.conv_layers.0.layer_norm.weight"] = \
        p["feature_extractor/group_norm/scale"]
    out["feature_extractor.conv_layers.0.layer_norm.bias"] = \
        p["feature_extractor/group_norm/bias"]
    out["feature_projection.layer_norm.weight"] = p["fp_norm/scale"]
    out["feature_projection.layer_norm.bias"] = p["fp_norm/bias"]
    out["feature_projection.projection.weight"] = p["fp_proj/kernel"].T
    out["feature_projection.projection.bias"] = p["fp_proj/bias"]

    v = p["pos_conv/conv/wn/v"]                    # (k, in/g, out)
    g = p["pos_conv/conv/wn/g"]                    # (out,)
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
    dense = (v * (g / np.maximum(norm, 1e-12))).transpose(2, 1, 0)
    out["encoder.pos_conv_embed.conv.weight_v"] = dense
    out["encoder.pos_conv_embed.conv.weight_g"] = np.linalg.norm(
        dense, axis=(0, 1), keepdims=True)
    out["encoder.pos_conv_embed.conv.bias"] = p["pos_conv/conv/bias"]
    out["encoder.layer_norm.weight"] = p["encoder_norm/scale"]
    out["encoder.layer_norm.bias"] = p["encoder_norm/bias"]

    i = 0
    while f"layer_{i}/q/kernel" in p:
        t, f = f"encoder.layers.{i}", f"layer_{i}"
        for tn, fn in (("attention.q_proj", "q"), ("attention.k_proj", "k"),
                       ("attention.v_proj", "v"),
                       ("attention.out_proj", "out"),
                       ("feed_forward.intermediate_dense", "ff1"),
                       ("feed_forward.output_dense", "ff2")):
            out[f"{t}.{tn}.weight"] = p[f"{f}/{fn}/kernel"].T
            out[f"{t}.{tn}.bias"] = p[f"{f}/{fn}/bias"]
        out[f"{t}.layer_norm.weight"] = p[f"{f}/norm1/scale"]
        out[f"{t}.layer_norm.bias"] = p[f"{f}/norm1/bias"]
        out[f"{t}.final_layer_norm.weight"] = p[f"{f}/norm2/scale"]
        out[f"{t}.final_layer_norm.bias"] = p[f"{f}/norm2/bias"]
        i += 1
    return _to_torch(out)


def bert_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """BertModel params -> HF BertModel names (inverse of the JAX package's
    ``models/bert.py`` ``convert_hf_bert``): dense kernels transposed to
    torch's (out, in), LayerNorm scale -> weight."""
    p = {k: np.asarray(v, np.float32)
         for k, v in ckpt.flatten_tree(params).items()}
    out: Dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": p["word_emb/embedding"],
        "embeddings.position_embeddings.weight": p["pos_emb/embedding"],
        "embeddings.token_type_embeddings.weight": p["type_emb/embedding"],
        "embeddings.LayerNorm.weight": p["emb_norm/scale"],
        "embeddings.LayerNorm.bias": p["emb_norm/bias"],
    }
    i = 0
    while f"layer_{i}/q/kernel" in p:
        t, f = f"encoder.layer.{i}", f"layer_{i}"
        for tn, fn in (("attention.self.query", "q"),
                       ("attention.self.key", "k"),
                       ("attention.self.value", "v"),
                       ("attention.output.dense", "attn_out"),
                       ("intermediate.dense", "ff1"),
                       ("output.dense", "ff2")):
            out[f"{t}.{tn}.weight"] = p[f"{f}/{fn}/kernel"].T
            out[f"{t}.{tn}.bias"] = p[f"{f}/{fn}/bias"]
        for tn, fn in (("attention.output.LayerNorm", "attn_norm"),
                       ("output.LayerNorm", "ff_norm")):
            out[f"{t}.{tn}.weight"] = p[f"{f}/{fn}/scale"]
            out[f"{t}.{tn}.bias"] = p[f"{f}/{fn}/bias"]
        i += 1
    return _to_torch(out)


def frcrn_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """FRCRN params and batch statistics -> the port's FRCRN state dict in
    the replica key scheme (inverse of the JAX package's
    ``audiokit/frcrn.py`` ``convert_frcrn_weights``): conv kernels HWIO ->
    torch (out, in, kf, kt), transposed-conv kernels (kf, kt, out, in) ->
    torch (in, out, kf, kt), dense kernels -> (out, in), the FSMN's
    depthwise kernel (taps, 1, D) -> (D, 1, taps, 1), BatchNorm scale /
    mean / var -> weight / running_mean / running_var."""
    p = {k: np.asarray(v, np.float32)
         for k, v in ckpt.flatten_tree(params).items()}
    s = {k: np.asarray(v, np.float32)
         for k, v in ckpt.flatten_tree(batch_stats).items()}
    out: Dict[str, np.ndarray] = {}
    renames = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}
    for tree in (p, s):
        for key, v in tree.items():
            *path, leaf = key.split("/")
            name = ".".join(path + [renames[leaf]])
            if leaf == "kernel" and v.ndim == 4:       # (conv) kf, kt, i, o
                v = v.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and v.ndim == 3:     # FSMN taps, 1, D
                v = v[:, 0, :].T[:, None, :, None]
            elif leaf == "kernel":
                v = v.T
            out[name] = v
    return _to_torch(out)


# ---- the ASR chain: inverses of the JAX package's four ASR converters -------

_LAYER = re.compile(r"^(encoders0|decoders3|encoders|decoders)_(\d+)$")


def _flax_leaf(leaf: str, v: np.ndarray):
    """A flax leaf as its torch name and layout: Dense kernels (in, out)
    -> (out, in), conv kernels (k, in, out) -> (out, in, k), LayerNorm scale
    and embedding -> weight."""
    if leaf == "kernel":
        return "weight", v.T if v.ndim == 2 else v.transpose(2, 1, 0)
    return {"scale": "weight", "embedding": "weight"}.get(leaf, leaf), v


def _sanm_names(params: Dict[str, Any], prefix: str = ""
                ) -> Dict[str, np.ndarray]:
    """Flax SAN-M trees (Paraformer, CT-punc) -> FunASR names: layer
    ``encoders_3`` -> ``encoders.3`` (``encoders0_0``, ``decoders3_0``
    alike), the encoder FSMN's ``fsmn_block/conv`` -> ``fsmn_block``."""
    out = {}
    for key, v in ckpt.flatten_tree(params).items():
        *path, leaf = key.split("/")
        path = [_LAYER.sub(r"\1.\2", p) for p in path if p != "conv"]
        name, v = _flax_leaf(leaf, np.asarray(v, np.float32))
        out[prefix + ".".join(path + [name])] = v
    return out


def _inner(params: Dict[str, Any]) -> Dict[str, Any]:
    return params.get("params", params)


def paraformer_state_dict(params: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """Paraformer params -> the port's Paraformer state dict, FunASR's names
    (inverse of ``audiokit/asr_paraformer.py convert_paraformer_weights``)."""
    return _to_torch(_sanm_names(_inner(params)))


def ct_punc_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """CT-Transformer params -> the port's CTTransformer state dict
    (inverse of ``audiokit/punc_ct.py convert_ct_punc_weights``): the
    encoder's layers and final norm under ``encoder.``, ``embed`` and the
    ``decoder`` head at the top."""
    p = dict(_inner(params))
    top = {k: p.pop(k) for k in ("embed", "decoder")}
    return _to_torch({**_sanm_names(top), **_sanm_names(p, "encoder.")})


def fsmn_vad_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """FSMN VAD params -> the port's FSMN state dict, FunASR's encoder names
    without the ``encoder.`` prefix (inverse of ``audiokit/vad_fsmn.py
    convert_fsmn_vad_weights``): each Dense under ``.linear``, the memory
    taps (k, 1, C) -> Conv2d (C, 1, k, 1)."""
    out = {}
    for key, v in ckpt.flatten_tree(_inner(params)).items():
        *path, leaf = key.split("/")
        v = np.asarray(v, np.float32)
        m = re.match(r"fsmn_(\d+)$", path[0])
        head = f"fsmn.{m.group(1)}" if m else path[0]
        if path[-1] in ("conv_left", "conv_right"):
            out[f"{head}.fsmn_block.{path[-1]}.weight"] = \
                v.transpose(2, 1, 0)[..., None]
            continue
        name, v = _flax_leaf(leaf, v)
        out[".".join([head] + path[1:] + ["linear", name])] = v
    return _to_torch(out)


def whisper_state_dict(enc_params: Dict[str, Any], dec_params: Dict[str, Any],
                       cross_params: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Whisper's three trees (encoder, decoder step, cross K/V) -> the
    port's Whisper state dict, HF's names without ``model.`` (inverse of
    ``audiokit/asr_whisper.py convert_whisper_weights``)."""
    out: Dict[str, np.ndarray] = {}

    def put(torch_name: str, flat: Dict[str, np.ndarray], key: str):
        for leaf in ("kernel", "bias", "scale", "embedding"):
            if f"{key}/{leaf}" in flat:
                name, v = _flax_leaf(leaf, flat[f"{key}/{leaf}"])
                out[f"{torch_name}.{name}"] = v

    enc = {k: np.asarray(v, np.float32)
           for k, v in ckpt.flatten_tree(_inner(enc_params)).items()}
    dec = {k: np.asarray(v, np.float32)
           for k, v in ckpt.flatten_tree(_inner(dec_params)).items()}
    cross = {k: np.asarray(v, np.float32)
             for k, v in ckpt.flatten_tree(_inner(cross_params)).items()}
    for name in ("conv1", "conv2", "layer_norm"):
        put(f"encoder.{name}", enc, name)
    i = 0
    while f"layer_{i}/fc1/kernel" in enc:
        t, f = f"encoder.layers.{i}", f"layer_{i}"
        for name in ("self_attn_layer_norm", "final_layer_norm", "fc1",
                     "fc2"):
            put(f"{t}.{name}", enc, f"{f}/{name}")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{t}.self_attn.{name}", enc, f"{f}/self_attn/{name}")
        i += 1
    out["decoder.embed_tokens.weight"] = dec["tok_emb/embedding"]
    out["decoder.embed_positions.weight"] = dec["pos_emb"]
    put("decoder.layer_norm", dec, "layer_norm")
    i = 0
    while f"layer_{i}_fc1/kernel" in dec:
        t, f = f"decoder.layers.{i}", f"layer_{i}"
        for tn, fn in (("self_attn_layer_norm", "self_ln"),
                       ("encoder_attn_layer_norm", "cross_ln"),
                       ("final_layer_norm", "ffn_ln"), ("fc1", "fc1"),
                       ("fc2", "fc2"), ("encoder_attn.q_proj", "cross_q"),
                       ("encoder_attn.out_proj", "cross_out")):
            put(f"{t}.{tn}", dec, f"{f}_{fn}")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{t}.self_attn.{name}", dec, f"{f}_self_attn/{name}")
        put(f"{t}.encoder_attn.k_proj", cross, f"{f}_cross_k")
        put(f"{t}.encoder_attn.v_proj", cross, f"{f}_cross_v")
        i += 1
    return _to_torch(out)
