"""s1 GPT fine-tune driver (JAX: train/gpt.py ``GPTTrain``).

* config = ``configs/gpt.yaml`` (read by ``utils/simple_yaml.py``: the card's
  hosts have no PyYAML) overlaid with the request params;
* data from ``6-name2semantic.tsv`` + ``2-name2text.txt`` (+ ``3-bert``)
  through the host loader ``train/data.py`` (``GPTDataset``,
  ``BucketBatcher`` over ``GPT_BOUNDARIES``, ``collate_gpt``), phonemes
  padded to a multiple of 16 over the dataset, tokens to the bucket's
  boundary;
* resume from the newest ``logs/ckpt/epoch=E-step=S.ckpt`` (model, the
  step's optimizer and accumulation state, S counting micro-batches as in
  JAX; this package's torch format), else the pretrained ``.ckpt`` merged
  where names and shapes match;
* a loss line to the connector (and the metrics to TensorBoard,
  ``tb_log_dir()/<name>``, where a writer imports) every 10 micro-batches,
  and the session data every epoch;
* per ``save_every_epoch``: the resume file and the deployable
  ``{name}-e{E}.ckpt`` in ``export_gpt_weights``' format (half precision,
  ``model.``-prefixed reference names).
* ``model.dropout`` of the yaml above 0: each micro-batch draws its dropout
  masks from the seed ``train.seed * 1_000_003 + micro-batch count`` (JAX:
  ``fold_in(fast_key(seed), step)``; the s2 trainer seeds its generator
  the same way).

Data parallel (``parallel/``, JAX ``train/gpt.py:148-150``, ``:205-239``):
the trainer joins the world first (``maybe_initialize``, a no-op outside
one); every rank builds the same seeded bucket schedule, wrap-pads each
batch to a multiple of the world and loads only its block of rows
(``process_local_rows``; DPO's rejected sequences are made over the global
batch first), and the step sums the gradients over the world.  Resume
files load on every rank; the resume files, exports, connector lines,
session data and TensorBoard are written by rank 0 alone.
``cmd/train_gpt.py`` starts the ranks (``EASEVOICE_DP``, ``EASEVOICE_TP``).

Tensor parallel (``parallel/gpt_sharding.py``, JAX ``train/gpt.py:203-221``):
on a grid with a model axis of 2 or more every rank builds the whole model
from the seed (and the optimizer's state from its initial values, the RMS
of whole tensors) and keeps its model index's shards; the pretrained merge
and a resume file are applied to the whole model and sharded the same way.
Rows go by the data index, so the ranks of a model group load the same
ones.  Resume files and exports hold whole tensors: the ranks of rank 0's
model group gather their shards (the parameters, ScaledAdam's
``exp_avg_sq`` and ``delta``, the accumulator) and rank 0 writes them, so a
file written on any grid loads on any other, a world of one included.

On ``GPTTrainParams.device``: the first CUDA card by default (a rank's
``cuda:<local index>`` in a world), which must exist (no silent move to
the host); ``"cpu"`` runs the kernels' plain twins.
On the card the model computes in bf16 when ``GlobalCFG().is_half`` (env
``is_half``, default True), as the JAX package does on an accelerator
(JAX ``train/gpt.py:162-163``: ``Text2SemanticDecoder(dtype=bfloat16)``),
through the bf16 instances of K1 and K5; ``is_half=False`` gives fp32.  A
"cpu" device computes in fp32 whatever ``is_half`` says, as the JAX package
does on its CPU platform.  Parameters, the optimizer state
(``EASEVOICE_OPT_STATE``), resume files and exports are the same either way.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..models.gpt import T2SConfig, Text2SemanticDecoder
from ..parallel import distributed, gpt_sharding, local_batch_multiple, \
    wrap_pad_indices
from ..utils import paths, simple_yaml
from ..utils.config import GlobalCFG
from ..utils.connector import MultiProcessOutputConnector
from ..utils.logger import logger
from ..utils.response import EaseVoiceResponse, ResponseStatus
from . import ckpt as ckpt_io
from . import data as data_mod
from .gpt_step import GPTTrainHP, GPTTrainStep
from .sovits import _round_up, _tb_writer, merge_matching, training_dtype


@dataclasses.dataclass
class GPTTrainParams:
    """Request schema (the JAX package's GPTTrainParams)."""

    batch_size: int = 12
    total_epochs: int = 15
    save_every_epoch: int = 5
    if_dpo: bool = False
    if_save_latest: bool = True
    if_save_every_weights: bool = True
    # accepted for API parity and ignored, as the JAX package ignores it:
    # EASEVOICE_DP and CUDA_VISIBLE_DEVICES choose the cards
    gpu_ids: str = "0"
    model_path: str = ""
    train_input_dir: str = ""
    output_model_name: str = ""
    project_dir: str = ""
    device: str = "cuda"         # "cpu" runs the plain twins of the kernels


def get_gpt_train_dir(project_dir: str, name: Optional[str]) -> str:
    if not name:
        name = "gpt_" + datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(project_dir, "models", "gpt_train", name)


def default_pretrained_gpt() -> str:
    """The JAX package's GlobalCFG default."""
    return GlobalCFG().gpt_path


# semantic-length buckets (25 Hz tokens; 54 s cap -> 1350)
GPT_BOUNDARIES = (0, 100, 200, 300, 400, 500, 700, 900, 1100, 1360)

LOG_EVERY = 10   # micro-batches between connector loss lines


def gpt_export_tree(state: Dict[str, torch.Tensor]):
    """A whole GPT state dict as the JAX package's flax-layout tree."""
    flat = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    tree, unmatched = ckpt_io.torch_to_flax(flat, ckpt_io.gpt_rules())
    if unmatched:
        raise KeyError(f"no GPT export rule for {unmatched[:5]}")
    return tree


def semantic_rows(dataset: data_mod.GPTDataset, idxs: List[int],
                  max_sem: int):
    """The semantic ids and lengths of ``idxs`` as ``collate_gpt`` pads
    them, with no BERT features loaded (DPO's global batch on a rank)."""
    sem = np.zeros((len(idxs), max_sem), np.int32)
    lens = np.zeros((len(idxs),), np.int32)
    for row, i in enumerate(idxs):
        codes = dataset.items[i][2][:max_sem]
        sem[row, :len(codes)] = codes
        lens[row] = len(codes)
    return sem, lens


def train_gpt(params: GPTTrainParams) -> EaseVoiceResponse:
    """One rank's fine-tune (``parallel.distributed.launch``'s target)."""
    return GPTTrain(params).train()


class GPTTrain:
    def __init__(self, params: GPTTrainParams):
        distributed.maybe_initialize(params.device)
        self.params = params
        self.cfg_yaml = simple_yaml.load(paths.gpt_config_path())
        self.model_cfg = T2SConfig.from_yaml_dict(self.cfg_yaml)
        train_cfg = self.cfg_yaml.get("train", {})
        self.hp = GPTTrainHP(if_dpo=params.if_dpo)
        self.seed = train_cfg.get("seed", 1234)
        self.epochs = params.total_epochs
        self.batch_size = params.batch_size
        if params.if_dpo:
            # DPO doubles the forward cost; the reference halves the batch
            self.batch_size = max(1, self.batch_size // 2)
        self.max_sec = self.cfg_yaml.get("data", {}).get("max_sec", 54)
        self.device = distributed.rank_device(params.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GPTTrain: device 'cuda' asked for and no "
                               "CUDA card is available; pass device='cpu' to "
                               "train on the host")
        self.compute_dtype = training_dtype(self.device)

        self.output_dir = get_gpt_train_dir(params.project_dir,
                                            params.output_model_name)
        self.name = os.path.basename(self.output_dir)
        self.ckpt_dir = os.path.join(self.output_dir, "logs", "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.pretrained = params.model_path or default_pretrained_gpt()
        self.connector = MultiProcessOutputConnector()
        self.step_fn: Optional[GPTTrainStep] = None
        # host seconds of each micro-batch, batch loading included, to the
        # end of its work on the device, and its padded token bucket
        self.step_seconds: List[float] = []
        self.step_tokens: List[int] = []

    # ---- checkpoints -------------------------------------------------------

    def _resume_file(self) -> Optional[str]:
        pat = re.compile(r"epoch=(\d+)-step=(\d+)\.ckpt$")
        best, best_key = None, (-1, -1)
        for f in os.listdir(self.ckpt_dir):
            m = pat.match(f)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                if key > best_key:
                    best, best_key = f, key
        return os.path.join(self.ckpt_dir, best) if best else None

    @staticmethod
    def _whole_state(model: Text2SemanticDecoder) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole tensors (under tensor
        parallelism gathered over the model group: every rank of it calls
        this)."""
        sd = model.state_dict()
        if model.tp is None:
            return sd
        return dict(zip(sd, gpt_sharding.gather_whole(list(sd.items()))))

    def _load_whole(self, model: Text2SemanticDecoder,
                    whole: Dict[str, torch.Tensor]) -> None:
        """Loads a whole state dict; a shard keeps its part."""
        if model.tp is not None:
            whole = gpt_sharding.shard_state_dict(whole, *model.tp)
        model.load_state_dict(whole, strict=True)

    def _save_resume(self, step_fn: GPTTrainStep, epoch: int) -> None:
        """Writes the resume file of whole tensors (rank 0; the other ranks
        of its model group only gather)."""
        state = {"model": self._whole_state(step_fn.model),
                 "train_step": step_fn.state_dict(), "epoch": epoch}
        if not distributed.is_primary():
            return
        path = os.path.join(self.ckpt_dir,
                            f"epoch={epoch}-step={step_fn.step}.ckpt")
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        if self.params.if_save_latest:
            for f in os.listdir(self.ckpt_dir):
                full = os.path.join(self.ckpt_dir, f)
                if full != path and f.endswith(".ckpt"):
                    os.remove(full)

    def _try_resume(self, step_fn: GPTTrainStep) -> int:
        """Loads the newest resume file when one exists; returns the first
        epoch to run."""
        path = self._resume_file()
        if path is None:
            return 1
        obj = torch.load(path, map_location=self.device, weights_only=False)
        self._load_whole(step_fn.model, obj["model"])
        step_fn.load_state_dict(obj["train_step"])
        logger.info("resumed from %s", path)
        return int(obj["epoch"]) + 1

    def _export_weights(self, model: Text2SemanticDecoder, epoch: int) -> str:
        """Writes the export of whole tensors (rank 0, as
        :meth:`_save_resume`); -> its path, "" on the other ranks."""
        whole = self._whole_state(model)
        if not distributed.is_primary():
            return ""
        path = os.path.join(self.output_dir, f"{self.name}-e{epoch}.ckpt")
        ckpt_io.export_gpt_weights(gpt_export_tree(whole), path,
                                   config=self.cfg_yaml, info=f"GPT-e{epoch}")
        return path

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if not t.is_floating_point():
                t = t.to(torch.int64)
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # ---- main loop ----------------------------------------------------------

    def train(self, on_step: Optional[Callable[[int, Dict], None]] = None
              ) -> EaseVoiceResponse:
        """Runs the fine-tune.  ``on_step(global_step, metrics)`` is called
        after every micro-batch with the metrics as 0-d tensors on the
        device."""
        t0 = time.time()
        dataset = data_mod.GPTDataset(self.params.train_input_dir,
                                      max_sec=self.max_sec)
        batcher = data_mod.BucketBatcher(
            dataset.lengths, self.batch_size, boundaries=GPT_BOUNDARIES,
            seed=self.seed)
        max_ph = _round_up(max(len(p) for (_, p, _) in dataset.items), 16)

        tp = None if distributed.model_size() == 1 else (
            distributed.model_rank(), distributed.model_size())
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)    # the modules' initial values
            model = whole = Text2SemanticDecoder(self.model_cfg,
                                                 dtype=self.compute_dtype)
            if tp is not None:
                model = Text2SemanticDecoder(self.model_cfg,
                                             dtype=self.compute_dtype, tp=tp)
                self._load_whole(model, whole.state_dict())
        model.to(self.device)
        # the optimizer's state comes from the initial values, as JAX's
        # create_train_state takes it before the pretrained merge
        step_fn = self.step_fn = GPTTrainStep(model, self.hp)
        start_epoch = self._try_resume(step_fn)
        if start_epoch == 1 and os.path.exists(self.pretrained):
            merge_matching(whole, convert.load_torch_state_dict(
                self.pretrained))
            if tp is not None:
                self._load_whole(model, whole.state_dict())
            logger.info("loaded pretrained GPT %s", self.pretrained)
        del whole

        primary = distributed.is_primary()
        # rank 0's model group gathers what rank 0 writes
        saver = distributed.data_rank() == 0
        writer = _tb_writer(os.path.join(paths.tb_log_dir(), self.name)) \
            if primary else None
        n_data = distributed.data_size()
        last: Dict[str, float] = {}
        for epoch in range(start_epoch, self.epochs + 1):
            for bucket_id, idxs in batcher.epoch_batches(epoch):
                t_step = time.perf_counter()
                tokens = _round_up(batcher.padded_frames(bucket_id), 2)
                idxs = wrap_pad_indices(idxs, local_batch_multiple(n_data))
                rows = distributed.batch_rows(len(idxs))
                local = distributed.process_local_rows(len(idxs))
                batch = data_mod.collate_gpt(
                    [dataset.load_item(idxs[r]) for r in local], max_ph,
                    tokens)
                if self.params.if_dpo:
                    from ..models.gpt.dpo import make_reject_y

                    # over the global batch, then the rank's rows
                    sem = (batch["semantic_ids"], batch["semantic_ids_len"]
                           ) if rows is None else semantic_rows(
                               dataset, idxs, tokens)
                    rej, rej_lens = make_reject_y(
                        *sem, np.random.default_rng(self.seed + step_fn.step),
                        max_len=tokens)
                    batch["reject_semantic_ids"] = rej[local]
                    batch["reject_semantic_ids_len"] = rej_lens[local]
                metrics = step_fn(self._to_device(batch),
                                  seed=self.seed * 1_000_003 + step_fn.step,
                                  rows=rows)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.step_seconds.append(time.perf_counter() - t_step)
                self.step_tokens.append(tokens)
                global_step = step_fn.step
                if on_step is not None:
                    on_step(global_step, metrics)
                if global_step % LOG_EVERY == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    if primary:
                        self.connector.write_loss(
                            global_step, last["loss"],
                            other={"acc": last["acc"], "lr": 0.002,
                                   "epoch": epoch})
                    if writer:
                        for k, v in last.items():
                            writer.add_scalar(k, v, global_step)
            if saver and (epoch % self.params.save_every_epoch == 0
                          or epoch == self.epochs):
                self._save_resume(step_fn, epoch)
                if self.params.if_save_every_weights:
                    self._export_weights(model, epoch)
            if primary:
                self.connector.write_session_data(
                    {"progress": f"{epoch}/{self.epochs}", "epoch": epoch})

        final = self._export_weights(model, self.epochs) if saver else ""
        if writer:
            writer.close()
        return EaseVoiceResponse(
            ResponseStatus.SUCCESS, "train gpt success",
            data={"model_path": final, "global_step": step_fn.step,
                  "elapsed_sec": round(time.time() - t0, 2), **last})
