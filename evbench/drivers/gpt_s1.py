"""The s1 GPT fine-tune cells: ``GPTTrainStep`` fed by the program's own
``GPTDataset.load_item`` + ``collate_gpt`` and the trainer's host-to-device
copy, in ``BucketBatcher`` order over a dataset folder written from the
seed, as ``GPTTrain.train`` runs it, with no checkpoint saves and no
TensorBoard.

Set-up writes the folder (``6-name2semantic.tsv``, ``2-name2text.txt`` and
``3-bert``), builds the model and ``GPTTrainStep`` with weights drawn on the
card from the seed, and drives the step through its first micro-batches,
which warm every bucket shape up and which the check follows.  The window
continues the same stream of micro-batches.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Dict

import numpy as np

from .. import compare, costs, traffic as traffic_mod
from ..common import TAG_ORDER, TAG_TRAFFIC, make_weights, round_up, \
    sub_seed
from ..reference import gpt_s1 as ref
from .base import TrainDriver, log_loss_gaps, log_worst

SEMANTIC_HZ = 25
__all__ = ["Driver", "flop_model", "ref"]


def flop_model(cfg: dict):
    """Model FLOPs of one utterance, forward and backward, at its unpadded
    (phonemes, semantic) lengths: FlopCounterMode over the reference, one
    layer and the layers' outside fitted apart (both exact polynomials)."""
    import torch

    shapes = ref.param_shapes(cfg)
    d = cfg["hidden_dim"]

    def params(names):
        return {k: torch.empty(shapes[k], requires_grad=True)
                for k in names}

    layer_names = [k for k in shapes if k.startswith("h.layers.0.")]
    outside = [k for k in shapes if not k.startswith("h.layers.")]

    def count_layer(t):
        def run():
            P = params(layer_names)
            h = torch.empty((1, t, d), requires_grad=True)
            mask = torch.ones((1, 1, t, t), dtype=torch.bool)
            out = ref.layer(P, 0, h, mask, cfg["head"], ref.FP32)
            torch.autograd.grad(out.sum(), [h, *P.values()])
        return costs.count_flops(run)

    def count_outside(p, s):
        def run():
            P = params(outside)
            x = torch.zeros((1, p), dtype=torch.long)
            y = torch.zeros((1, s), dtype=torch.long)
            out = ref.loss(P, {**cfg, "n_layer": 0}, x, torch.tensor([p]), y,
                           torch.tensor([s]), torch.empty((1, p, 1024)))
            torch.autograd.grad(out, list(P.values()), allow_unused=True)
        return costs.count_flops(run)

    layer_terms = [lambda t: t, lambda t: t * t]
    head_terms = [lambda p, s: p, lambda p, s: s]
    fits = costs.cached(cfg, [ref.__file__, costs.__file__, __file__],
                        lambda: {
        "layer": costs.coef_strings(costs.PolyFlops(
            layer_terms, count_layer, [(64,), (96,), (160,)])),
        "head": costs.coef_strings(costs.PolyFlops(
            head_terms, count_outside, [(16, 32), (24, 40), (40, 72)]))})
    per_layer = costs.PolyFlops(layer_terms, coef=fits["layer"])
    head = costs.PolyFlops(head_terms, coef=fits["head"])
    n = cfg["n_layer"]
    return lambda p, s: n * per_layer(p + s) + head(p, s)


class Driver(TrainDriver):
    rate_metric = "s1_audio_s_per_s"
    program_state = ("step_fn", "dataset")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        super().__init__(cfg, traffic, seed, device)
        self.accum = cfg["grad_accum"]
        self.n_ref = self.check_cfg["optimizer_steps"] * self.accum

    # ---- the dataset folder ------------------------------------------------

    def _write_dataset(self, root: str) -> None:
        torch = self.torch
        items = traffic_mod.items(self.traffic, self.seed)
        table = traffic_mod.symbols()
        n_sem = [max(2, int(round(it.seconds * SEMANTIC_HZ))) for it in items]
        n_ph = [len(it.phonemes) for it in items]
        s = sub_seed(self.seed, TAG_TRAFFIC + 100)
        codes = traffic_mod.random_ints(torch, sum(n_sem),
                                        self.cfg["vocab_size"] - 1, s,
                                        self.device)
        bert = traffic_mod.random_normal(torch, 1024 * sum(n_ph), s + 1,
                                         self.device, torch.float16)
        os.makedirs(os.path.join(root, "3-bert"))
        self.raw: Dict[str, dict] = {}
        sem_lines, txt_lines = ["item_name\tsemantic_audio"], []
        at_c = at_b = 0
        for it, ns, nph in zip(items, n_sem, n_ph):
            c = codes[at_c:at_c + ns]
            b = bert[at_b:at_b + 1024 * nph].reshape(1024, nph)
            at_c += ns
            at_b += 1024 * nph
            np.save(os.path.join(root, "3-bert", it.name + ".npy"), b)
            sem_lines.append(it.name + "\t" + " ".join(map(str, c.tolist())))
            txt_lines.append("\t".join([
                it.name, " ".join(table[i] for i in it.phonemes),
                " ".join(["1"] * nph), "x"]))
            self.raw[it.name] = {"phonemes": it.phonemes, "codes": c,
                                 "bert": b}
        for name, lines in (("6-name2semantic.tsv", sem_lines),
                            ("2-name2text.txt", txt_lines)):
            with open(os.path.join(root, name), "w", encoding="utf8") as f:
                f.write("\n".join(lines) + "\n")

    # ---- set-up -------------------------------------------------------------

    def setup(self) -> None:
        torch = self.torch
        from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
            Text2SemanticDecoder
        from easevoice_trainer_tpu_torch.train import data as data_mod
        from easevoice_trainer_tpu_torch.train.gpt import GPT_BOUNDARIES, \
            GPTTrain
        from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
            GPTTrainStep

        cfg = self.cfg
        self.tmp = tempfile.TemporaryDirectory(prefix="evbench-s1-")
        self._write_dataset(self.tmp.name)
        self.mark("dataset written")
        flops = flop_model(cfg)
        self.item_flops = {name: flops(len(r["phonemes"]), len(r["codes"]))
                           for name, r in self.raw.items()}
        self.dataset = data_mod.GPTDataset(self.tmp.name,
                                           max_sec=cfg["max_sec"])
        self.collate = data_mod.collate_gpt
        self.batcher = data_mod.BucketBatcher(
            self.dataset.lengths, self.traffic["batch_size"],
            boundaries=GPT_BOUNDARIES,
            seed=sub_seed(self.seed, TAG_ORDER, 31))
        self.max_ph = round_up(max(len(p) for (_, p, _) in
                                   self.dataset.items), 16)
        # the trainer's own host-to-device copy
        self.to_device = lambda b: GPTTrain._to_device(self, b)
        with torch.device(self.device):
            model = Text2SemanticDecoder(
                T2SConfig.from_yaml_dict({"model": cfg}), dtype=self.dtype)
        model.to(self.device)
        model.load_state_dict(self.initial(), strict=True)
        self.step_fn = GPTTrainStep(model, GPTTrainHP(grad_accum=self.accum))
        self.mark("model built")
        self.stream = self._stream(self.batcher)
        buckets = {b for b, idx in enumerate(self.batcher.buckets) if idx}
        seen = set()
        self.prefix_losses = []
        while len(self.records) < self.n_ref or not buckets <= seen:
            seen.add(self.run_step()["bucket"])
        self.prefix = self.records[:self.n_ref]
        self.records = []

    def after_step(self, rec: dict, metrics: dict) -> None:
        k = len(self.records) + 1      # the set-up's steps come first
        if self.prefix is not None or k > self.n_ref:
            return
        self.prefix_losses.append(float(metrics["loss"]))
        if k == self.accum:
            self.first_grads = self._grads_from_state()
        if k == self.n_ref:
            self.after = {n: p.detach().float().cpu().clone() for n, p in
                          zip(self.step_fn.names, self.step_fn.params)}

    def _grads_from_state(self) -> Dict[str, float]:
        """Each leaf's norm of the gradient ScaledAdam took at its first
        step, from its state: exp_avg_sq = (1 - beta2) g^2."""
        opt = self.step_fn.optimizer
        b2 = opt.param_groups[0]["betas"][1]
        return {n: math.sqrt(float(opt.state[p]["exp_avg_sq"].float().sum())
                             / (1.0 - b2))
                for n, p in zip(self.step_fn.names, self.step_fn.params)}

    def initial(self) -> dict:
        return make_weights(ref.param_shapes(self.cfg), self.seed,
                            self.device, ref.init_rule)

    # ---- one micro-batch ----------------------------------------------------

    def load(self):
        bucket, idxs = next(self.stream)
        tokens = round_up(self.batcher.padded_frames(bucket), 2)
        items = [self.dataset.load_item(i) for i in idxs]
        batch = self.collate(items, self.max_ph, tokens)
        dev = self.to_device(batch)
        names = [it["name"] for it in items]
        x_lens = batch["phoneme_ids_len"].tolist()
        y_lens = batch["semantic_ids_len"].tolist()
        return dev, {
            "bucket": bucket, "names": names, "x_len": self.max_ph,
            "y_len": tokens, "x_lens": x_lens, "y_lens": y_lens,
            "audio_s": sum(y_lens) / SEMANTIC_HZ,
            "flops": sum(self.item_flops[n] for n in names),
            "heads": self.cfg["head"],
            "dk": self.cfg["hidden_dim"] // self.cfg["head"],
            "layers": self.cfg["n_layer"]}

    def step(self, batch, rec):
        return self.step_fn(batch,
                            seed=self.seed * 1_000_003 + self.step_fn.step)

    # ---- the check ----------------------------------------------------------

    def ref_batch(self, rec: dict) -> dict:
        torch = self.torch
        b = len(rec["names"])
        x = np.zeros((b, rec["x_len"]), np.int64)
        y = np.zeros((b, rec["y_len"]), np.int64)
        bert = np.zeros((b, rec["x_len"], 1024), np.float32)
        xl, yl = [], []
        for i, name in enumerate(rec["names"]):
            raw = self.raw[name]
            ph, c = raw["phonemes"], raw["codes"]
            x[i, :len(ph)] = ph
            y[i, :len(c)] = c
            bert[i, :len(ph)] = raw["bert"].T
            xl.append(len(ph))
            yl.append(len(c))
        dev = self.device
        return {"x": torch.from_numpy(x).to(dev),
                "y": torch.from_numpy(y).to(dev),
                "bert": torch.from_numpy(bert).to(dev),
                "x_lens": torch.tensor(xl, device=dev),
                "y_lens": torch.tensor(yl, device=dev)}

    def follow(self, q=ref.FP32, half_rows: bool = False) -> dict:
        """The reference over the set-up's first micro-batches: their
        losses, the first optimizer step's gradient norms by leaf, and the
        parameters after the last step.  ``q`` rounds its products (a
        control); ``half_rows`` leaves out half of each batch and doubles
        the rest's sum (a fault)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        P = self.initial()
        opt = ref.ScaledAdam(P)
        losses, first, acc = [], None, None
        rows = self.check_cfg["rows_per_block"]
        for k, rec in enumerate(self.prefix):
            batch = self.ref_batch(rec)
            scale = 1.0
            if half_rows:
                n = batch["x"].shape[0] // 2
                batch = {key: v[:n] for key, v in batch.items()}
                scale = 2.0
            loss, grads = ref.micro_batch_grads(P, self.cfg, batch, rows, q)
            losses.append(loss * scale)
            acc = {n: g * scale for n, g in grads.items()} if acc is None \
                else {n: acc[n] + g * scale for n, g in grads.items()}
            if (k + 1) % self.accum == 0:
                mean = {n: g / self.accum for n, g in acc.items()}
                if first is None:
                    first = mean
                opt.step(P, mean)
                acc = None
        return {"losses": losses, "params": P, "first_grad_tensors": first,
                "first_grads": {n: float(g.norm()) for n, g in first.items()}}

    def numbers(self, program: dict, reference: dict) -> Dict[str, float]:
        P0 = self.initial()
        masks = compare.moving_masks(reference["first_grad_tensors"])
        ref_change = compare.masked_change_norms(reference["params"], P0,
                                                 masks, self.device)
        prog_change = compare.masked_change_norms(program["params"], P0,
                                                  masks, self.device)
        log_loss_gaps(program["losses"], reference["losses"])
        log_worst("grad_gap", program["first_grads"],
                  reference["first_grads"])
        log_worst("change_gap", prog_change, ref_change)
        return {
            "loss_gap": compare.loss_gap(program["losses"],
                                         reference["losses"]),
            "grad_gap": compare.leaf_gap(program["first_grads"],
                                         reference["first_grads"]),
            "change_gap": compare.leaf_gap(prog_change, ref_change),
        }

    def program_result(self) -> dict:
        return {"losses": self.prefix_losses,
                "first_grads": self.first_grads, "params": self.after}
