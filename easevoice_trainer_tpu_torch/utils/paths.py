"""Artifact-directory and pretrained-model path contract.

The on-disk layout matches the reference so that datasets, checkpoints and
the SPA frontend interoperate (reference: src/utils/config/__init__.py:5-45,
src/service/namespace.py:57-67):

per-project preprocessing outputs::

    vocals/ accompaniments/ slices/ denoises/
    asrs/asr.list  refinements/refinement.list
    <normalize-run>/2-name2text.txt  3-bert/  4-cnhubert/  5-wav32k/
                    6-name2semantic.tsv
    models/{sovits_train,gpt_train}/<name>/...

namespace skeleton::

    voices/ outputs/ training-audios/ models/{sovits_train,gpt_train}
    .metadata.json
"""
from __future__ import annotations

import os

# ---- repo/runtime roots ----------------------------------------------------


def get_base_path() -> str:
    """Root of the running installation (repo checkout or site-packages)."""
    env = os.environ.get("EASEVOICE_BASE_PATH")
    if env:
        return env
    # package dir -> repo root
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


MODEL_ROOT = "models"

# ---- per-project artifact names (file-format contract) ----------------------
VOCALS_OUTPUT = "vocals"
ACCOMPANIMENTS_OUTPUT = "accompaniments"
SLICES_OUTPUT = "slices"
DENOISES_OUTPUT = "denoises"
ASRS_OUTPUT = "asrs"
ASR_FILE = "asr.list"
REFINEMENTS_OUTPUT = "refinements"
REFINEMENT_FILE = "refinement.list"

TEXT_OUTPUT_NAME = "2-name2text.txt"
BERT_OUTPUT = "3-bert"
SSL_OUTPUT = "4-cnhubert"
WAV_OUTPUT = "5-wav32k"
SEMANTIC_OUTPUT = "6-name2semantic.tsv"

SOVITS_TRAIN_DIR = os.path.join(MODEL_ROOT, "sovits_train")
GPT_TRAIN_DIR = os.path.join(MODEL_ROOT, "gpt_train")

# ---- namespace skeleton ------------------------------------------------------
NAMESPACE_SUBDIRS = (
    "voices",
    "outputs",
    "training-audios",
    SOVITS_TRAIN_DIR,
    GPT_TRAIN_DIR,
)
NAMESPACE_METADATA = ".metadata.json"


def pretrained_root(base_path: str | None = None) -> str:
    return os.path.join(base_path or get_base_path(), MODEL_ROOT, "pretrained")


def tb_log_dir(base_path: str | None = None) -> str:
    return os.path.join(base_path or get_base_path(), "tb_logs")


def configs_dir(base_path: str | None = None) -> str:
    return os.path.join(base_path or get_base_path(), "configs")


def s2_config_path(base_path: str | None = None) -> str:
    return os.path.join(configs_dir(base_path), "s2.json")


def gpt_config_path(base_path: str | None = None) -> str:
    return os.path.join(configs_dir(base_path), "gpt.yaml")


def tts_infer_config_path(base_path: str | None = None) -> str:
    return os.path.join(configs_dir(base_path), "tts_infer.yaml")
