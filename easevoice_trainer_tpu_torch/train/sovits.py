"""s2 SoVITS fine-tune driver (JAX: train/sovits.py SovitsTrain).

* config = ``configs/s2.json`` overlaid with the request params;
* data from the normalize output dir (2-name2text / 4-cnhubert / 5-wav32k)
  through the host loader ``train/data.py`` (``S2Dataset``,
  ``BucketBatcher``, ``collate_s2``);
* resume from ``logs/{G,D}_latest.pth`` (this package's torch format) when
  present, else the pretrained s2G/s2D ``.pth`` merged where names and
  shapes match;
* a loss line to the connector every ``log_interval`` steps, and every 5
  steps the step's scalars to TensorBoard (``tb_log_dir()/<name>``) where
  ``torch.utils.tensorboard`` (or ``tensorboardX``) imports;
* per ``save_every_epoch``: resume files + the half-precision deployable
  ``{name}_e{E}_s{S}.pth`` (``{"weight", "config", "info"}``, no ``enc_q``).

On ``SovitsTrainParams.device``: the first CUDA card by default, which
must exist (no silent move to the host); ``"cpu"`` runs the kernels' plain
twins.  On the card both models compute in bf16 when ``GlobalCFG().is_half``
(env ``is_half``, default True), as the JAX package does on an accelerator
(JAX ``train/sovits.py:204-206``), the ResBlocks through the bf16 instances
of K3 and K4; ``is_half=False`` gives fp32, and so does a "cpu" device
whatever ``is_half`` says (the JAX package on its CPU platform).
Parameters, the optimizer state, resume files and exports are the same
either way.  Defaults (pretrained paths, output dirs) come from the port's
own ``utils/paths.py`` and ``utils/config.py`` (the environment).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..models.sovits import MultiPeriodDiscriminator, SovitsConfig, \
    SynthesizerTrn
from ..ops.stft import MelConfig
from ..utils import paths
from ..utils.config import GlobalCFG
from ..utils.connector import MultiProcessOutputConnector
from ..utils.logger import logger
from ..utils.response import EaseVoiceResponse, ResponseStatus
from . import ckpt as ckpt_io
from . import data as data_mod
from .sovits_step import S2TrainHP, S2TrainStep

TRAIN_LOGS_PATH = "logs"


@dataclasses.dataclass
class SovitsTrainParams:
    """Request schema (the JAX package's SovitsTrainParams)."""

    batch_size: int = 12
    total_epochs: int = 8
    text_low_lr_rate: float = 0.4
    pretrained_s2G: str = ""
    pretrained_s2D: str = ""
    if_save_latest: bool = True
    if_save_every_weights: bool = True
    save_every_epoch: int = 5
    gpu_ids: str = "0"           # accepted for API parity; one card is used
    train_input_dir: str = ""
    output_model_name: str = ""
    project_dir: str = ""
    device: str = "cuda"         # "cpu" runs the plain twins of the kernels


def get_sovits_train_dir(project_dir: str, name: Optional[str]) -> str:
    if not name:
        name = "sovits_" + datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(project_dir, "models", "sovits_train", name)


def default_pretrained_s2g() -> str:
    """The JAX package's GlobalCFG default."""
    return GlobalCFG().sovits_path


@torch.no_grad()
def merge_matching(module: torch.nn.Module,
                   loaded: Dict[str, torch.Tensor]) -> int:
    """Copy ``loaded`` into ``module`` where names and shapes match; the rest
    keeps its current values (the JAX driver's ``_merge_matching``).  Returns
    the number of shape-mismatched keys."""
    merged = {}
    skipped = 0
    for k, v in module.state_dict().items():
        cand = loaded.get(k)
        if cand is not None and tuple(cand.shape) == tuple(v.shape):
            merged[k] = cand
        else:
            merged[k] = v
            skipped += cand is not None
    module.load_state_dict(merged, strict=True)   # refolds weight norm
    if skipped:
        logger.warning("pretrained merge: %d shape-mismatched keys kept "
                       "current init", skipped)
    return skipped


def export_sovits_weights(net_g: SynthesizerTrn, path: str, config: Any,
                          info: str) -> None:
    """Deployable export: fp16, no ``enc_q`` (JAX: ckpt.py:483)."""
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in net_g.state_dict().items()
            if not k.startswith("enc_q.")}
    ckpt_io.save_torch_state(
        flat, path,
        wrapper=lambda sd: {"weight": sd, "config": config, "info": info},
        half=True)


def _tb_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` on ``log_dir``, or None with a
    warning where no writer imports (JAX: train/sovits.py ``_tb_writer``)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        return SummaryWriter(log_dir)
    except Exception:
        try:
            from tensorboardX import SummaryWriter

            os.makedirs(log_dir, exist_ok=True)
            return SummaryWriter(log_dir)
        except Exception:
            logger.warning("tensorboard unavailable; scalars not written")
            return None


def training_dtype(device: torch.device) -> Optional[torch.dtype]:
    """The fine-tunes' compute dtype: bf16 on a CUDA device when
    ``GlobalCFG().is_half``, else None (fp32), as the JAX trainers take
    ``jnp.bfloat16 if GlobalCFG().is_half else None``."""
    if device.type == "cuda" and GlobalCFG().is_half:
        return torch.bfloat16
    return None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SovitsTrain:
    def __init__(self, params: SovitsTrainParams):
        self.params = params
        with open(paths.s2_config_path(), encoding="utf8") as f:
            self.raw_cfg = json.load(f)
        train_cfg = self.raw_cfg.get("train", {})
        data_cfg = self.raw_cfg.get("data", {})

        self.model_cfg = SovitsConfig.from_json_dict(self.raw_cfg)
        self.hp = S2TrainHP(
            learning_rate=train_cfg.get("learning_rate", 1e-4),
            betas=tuple(train_cfg.get("betas", (0.8, 0.99))),
            eps=train_cfg.get("eps", 1e-9),
            lr_decay=train_cfg.get("lr_decay", 0.999875),
            segment_size=train_cfg.get("segment_size", 20480),
            c_mel=train_cfg.get("c_mel", 45),
            c_kl=train_cfg.get("c_kl", 1.0),
            text_low_lr_rate=params.text_low_lr_rate,
        )
        self.mel_cfg = MelConfig(
            sampling_rate=data_cfg.get("sampling_rate", 32000),
            n_fft=data_cfg.get("filter_length", 2048),
            hop_length=data_cfg.get("hop_length", 640),
            win_length=data_cfg.get("win_length", 2048),
            n_mels=data_cfg.get("n_mel_channels", 128),
            fmin=data_cfg.get("mel_fmin", 0.0),
            fmax=data_cfg.get("mel_fmax", None),
        )
        self.epochs = params.total_epochs
        self.batch_size = params.batch_size
        self.log_interval = train_cfg.get("log_interval", 10)
        self.seed = train_cfg.get("seed", 1234)
        self.device = torch.device(params.device)
        self.compute_dtype = training_dtype(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SovitsTrain: device 'cuda' asked for and no "
                               "CUDA card is available; pass device='cpu' to "
                               "train on the host")

        self.output_dir = get_sovits_train_dir(params.project_dir,
                                               params.output_model_name)
        self.name = os.path.basename(self.output_dir)
        self.train_logs_dir = os.path.join(self.output_dir, TRAIN_LOGS_PATH)
        os.makedirs(self.train_logs_dir, exist_ok=True)

        self.pretrained_s2G = params.pretrained_s2G or default_pretrained_s2g()
        self.pretrained_s2D = params.pretrained_s2D or \
            default_pretrained_s2g().replace("s2G", "s2D")
        self.connector = MultiProcessOutputConnector()
        self.step_fn: Optional[S2TrainStep] = None
        # host seconds of each step, batch loading included, to the end of
        # its work on the device
        self.step_seconds: List[float] = []

    # ---- checkpoint helpers -------------------------------------------------

    def _resume_path(self, which: str) -> str:
        return os.path.join(self.train_logs_dir, f"{which}_latest.pth")

    def _save_resume(self, step_fn: S2TrainStep, epoch: int) -> None:
        for which, net, opt in (("G", step_fn.net_g, step_fn.optim_g),
                                ("D", step_fn.net_d, step_fn.optim_d)):
            path = self._resume_path(which)
            torch.save({"model": net.state_dict(),
                        "optimizer": opt.state_dict(), "iteration": epoch},
                       path + ".tmp")
            os.replace(path + ".tmp", path)
        with open(os.path.join(self.train_logs_dir, "resume.json"), "w") as f:
            json.dump({"epoch": epoch, "step": step_fn.step}, f)

    def _try_resume(self, step_fn: S2TrainStep) -> int:
        """Loads the resume files when all exist; returns the first epoch
        to run."""
        meta_path = os.path.join(self.train_logs_dir, "resume.json")
        files = [self._resume_path("G"), self._resume_path("D"), meta_path]
        if not all(os.path.exists(p) for p in files):
            return 1
        for which, net, opt in (("G", step_fn.net_g, step_fn.optim_g),
                                ("D", step_fn.net_d, step_fn.optim_d)):
            obj = torch.load(self._resume_path(which),
                             map_location=self.device, weights_only=False)
            net.load_state_dict(obj["model"], strict=True)
            opt.load_state_dict(obj["optimizer"])
        with open(meta_path) as f:
            meta = json.load(f)
        logger.info("resumed from %s (epoch %s)", self.train_logs_dir,
                    meta["epoch"])
        return meta["epoch"] + 1

    def _load_pretrained(self, net_g, net_d) -> None:
        for path, net in ((self.pretrained_s2G, net_g),
                          (self.pretrained_s2D, net_d)):
            if os.path.exists(path):
                merge_matching(net, convert.load_torch_state_dict(path))
                logger.info("loaded pretrained %s", path)

    def _export_weights(self, net_g: SynthesizerTrn, epoch: int,
                        step: int) -> str:
        path = os.path.join(self.output_dir,
                            f"{self.name}_e{epoch}_s{step}.pth")
        export_sovits_weights(net_g, path, self.raw_cfg,
                              f"{epoch}epoch_{step}iteration")
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
        after every step with the metrics as 0-d tensors on the device."""
        t_start = time.time()
        dataset = data_mod.S2Dataset(
            self.params.train_input_dir, hop_length=self.mel_cfg.hop_length,
            sampling_rate=self.mel_cfg.sampling_rate,
            n_fft=self.mel_cfg.n_fft, win_length=self.mel_cfg.win_length)
        batcher = data_mod.BucketBatcher(
            dataset.lengths, self.batch_size, seed=self.seed)
        steps_per_epoch = max(len(batcher.epoch_batches(0)), 1)
        text_cap = _round_up(max(len(e.phoneme_ids)
                                 for e in dataset.examples), 16)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)    # the modules' initial values
            net_g = SynthesizerTrn(self.model_cfg, with_enc_q=True,
                                   dtype=self.compute_dtype)
            net_d = MultiPeriodDiscriminator(dtype=self.compute_dtype)
        net_g.to(self.device)
        net_d.to(self.device)
        step_fn = self.step_fn = S2TrainStep(
            net_g, net_d, self.hp, self.mel_cfg,
            steps_per_epoch=steps_per_epoch)
        start_epoch = self._try_resume(step_fn)
        if start_epoch == 1:
            self._load_pretrained(net_g, net_d)

        generator = torch.Generator(device=self.device)
        writer = _tb_writer(os.path.join(paths.tb_log_dir(), self.name))
        last_metrics: Dict[str, float] = {}
        for epoch in range(start_epoch, self.epochs + 1):
            for bucket_id, idxs in batcher.epoch_batches(epoch):
                t_step = time.perf_counter()
                batch = self._to_device(data_mod.collate_s2(
                    [dataset.load_item(i) for i in idxs],
                    batcher.padded_frames(bucket_id), text_cap,
                    hop=self.mel_cfg.hop_length))
                generator.manual_seed(self.seed * 1_000_003 + step_fn.step)
                metrics = step_fn(batch, generator)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.step_seconds.append(time.perf_counter() - t_step)
                global_step = step_fn.step
                if on_step is not None:
                    on_step(global_step, metrics)
                if global_step % self.log_interval == 0:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    self.connector.write_loss(
                        global_step, last_metrics["loss/g/total"],
                        other={
                            "loss/g/total": last_metrics["loss/g/total"],
                            "loss/d/total": last_metrics["loss/d/total"],
                            "learning_rate": self.hp.learning_rate
                            * (self.hp.lr_decay ** (epoch - 1)),
                        })
                if writer and global_step % 5 == 0:
                    for k, v in metrics.items():
                        writer.add_scalar(k, float(v), global_step)
            if epoch % self.params.save_every_epoch == 0 \
                    or epoch == self.epochs:
                self._save_resume(step_fn, epoch)
                if self.params.if_save_every_weights:
                    self._export_weights(net_g, epoch, step_fn.step)
            self.connector.write_session_data(
                {"progress": f"{epoch}/{self.epochs}", "epoch": epoch})

        final_path = self._export_weights(net_g, self.epochs, step_fn.step)
        if writer:
            writer.close()
        return EaseVoiceResponse(
            ResponseStatus.SUCCESS, "train sovits success",
            data={
                "model_path": final_path,
                "global_step": step_fn.step,
                "elapsed_sec": round(time.time() - t_start, 2),
                **last_metrics,
            })
