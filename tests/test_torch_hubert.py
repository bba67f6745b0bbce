"""Parity of the PyTorch port's CNHubert with the JAX package, including
the lengths mask of a padded batch.  fp32 on the CPU; tolerance 1e-4
relative to the reference's largest magnitude (matmul/conv summation
order)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models import cnhubert as jhub
from easevoice_trainer_tpu_torch.models import cnhubert as phub

from _torch_port_tiny import HUBERT_KW, assert_close, tiny_hubert


@pytest.fixture(scope="module")
def hubert():
    port, params, state = tiny_hubert()
    return port, jhub.CNHubert(jhub.HubertConfig(**HUBERT_KW)), params, state


def test_convert_roundtrip_is_exact(hubert):
    port, _, _, state = hubert
    # the HF pos-conv (g, v) split is rebuilt from the dense kernel, so
    # compare folded weights there and raw tensors everywhere else
    for k, v in port.state_dict().items():
        if "pos_conv_embed.conv.weight_" in k:
            continue
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    g = torch.from_numpy(state["encoder.pos_conv_embed.conv.weight_g"])
    v = torch.from_numpy(state["encoder.pos_conv_embed.conv.weight_v"])
    want = g * v / v.norm(dim=(0, 1), keepdim=True)
    torch.testing.assert_close(port.encoder.pos_conv_embed.conv.weight, want)


def test_hubert_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jhub.HubertConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(phub.HubertConfig)]
    assert jf == pf


def test_feat_output_lengths_match_jax():
    lens = np.array([400, 16000, 16319, 16320, 84800])
    np.testing.assert_array_equal(phub.feat_output_lengths(lens),
                                  jhub.feat_output_lengths(lens))


@pytest.mark.parametrize("masked", [False, True])
def test_cnhubert_matches_jax(hubert, masked):
    port, jmodel, params, _ = hubert
    rng = np.random.default_rng(9)
    wav = rng.uniform(-0.3, 0.3, (2, 16000)).astype(np.float32)
    lens = np.array([16000, 11000], np.int32) if masked else None
    if masked:
        wav[1, 11000:] = 0.0
    want = jax.jit(lambda p, w, n: jmodel.apply({"params": p}, w, n))(
        params, wav, lens)
    got = port(torch.from_numpy(wav),
               torch.from_numpy(lens).long() if masked else None)
    assert_close(got.numpy(), want, 1e-4, "hubert")
    if masked:
        # the masked padded row equals the same clip run alone, unpadded
        alone = port(torch.from_numpy(wav[1:, :11000].copy()))
        frames = alone.shape[1]
        assert_close(got[1:, :frames].numpy(), alone.numpy(), 1e-4, "mask")


def test_hf_state_for_load_reads_hf_spellings():
    state = {"masked_spec_embed": torch.zeros(4),
             "encoder.pos_conv_embed.conv.parametrizations.weight.original0":
                 torch.ones(1, 1, 3),
             "encoder.pos_conv_embed.conv.parametrizations.weight.original1":
                 torch.ones(4, 2, 3)}
    assert set(phub.hf_state_for_load(state)) == {
        "encoder.pos_conv_embed.conv.weight_g",
        "encoder.pos_conv_embed.conv.weight_v"}


def test_load_cnhubert_from_hf_dir(hubert, tmp_path):
    port, _, _, _ = hubert
    cfg = {"conv_dim": list(HUBERT_KW["conv_dim"]), "hidden_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 128, "num_conv_pos_embeddings": 16,
           "num_conv_pos_embedding_groups": 4}
    import json

    (tmp_path / "config.json").write_text(json.dumps(cfg))
    assert phub.load_cnhubert(str(tmp_path), device="cpu") is None
    sd = dict(port.state_dict())
    sd["masked_spec_embed"] = torch.zeros(64)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    loaded = phub.load_cnhubert(str(tmp_path), device="cpu")
    wav = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.3, 0.3, (1, 8000)).astype(np.float32))
    torch.testing.assert_close(loaded(wav), port(wav), rtol=0, atol=0)
