"""The s2 SoVITS fine-tune cells: ``S2TrainStep`` (the generator forward,
the discriminator's step, then the generator's step) fed by the program's
own ``S2Dataset.load_item`` + ``collate_s2`` and the trainer's
host-to-device copy, in ``BucketBatcher`` order over a dataset folder
written from the seed, as ``SovitsTrain.train`` runs it, with no
checkpoint saves and no TensorBoard.

Set-up writes the folder (``2-name2text.txt``, ``4-cnhubert`` and
``5-wav32k``), builds both nets and ``S2TrainStep`` with weights drawn on
the card from the seed, and runs the first steps, which warm every bucket
shape up and which the check follows.  Each step takes draws the benchmark
makes from the seed and hands to the reference too: the slice starts, the
posterior noise and the seed of the generator its dropout masks come from.
"""
from __future__ import annotations

import os
import tempfile
import wave
from typing import Dict, List

import numpy as np

from .. import compare, costs, traffic as traffic_mod
from ..common import TAG_ORDER, TAG_STEP, TAG_TRAFFIC, log, make_weights, \
    round_up, sub_seed
from ..reference import sovits_s2 as ref
from .base import TrainDriver, leaf_norms, log_loss_gaps, log_worst

__all__ = ["Driver", "flop_model", "ref"]


def flop_model(cfg: dict):
    """Model FLOPs of one clip, G and D, forward and backward: the part
    that grows with the clip's frames T and phonemes Tt (the style, text
    and posterior encoders and the flow), fitted as an exact polynomial,
    plus the fixed segment's (the decoder and both discriminator passes),
    counted once; FlopCounterMode over the reference on the meta device."""
    import torch

    gs, ds = ref.generator_shapes(cfg), ref.discriminator_shapes(cfg)
    spec_ch = cfg["data"]["filter_length"] // 2 + 1
    inter = cfg["model"]["inter_channels"]
    seg = cfg["train"]["segment_size"]
    hop = cfg["data"]["hop_length"]

    def params(shapes):
        return {k: torch.empty(v, requires_grad=not k.startswith(ref.FROZEN))
                for k, v in shapes.items()}

    def front(t, tt):
        def run():
            G = params(gs)
            batch = {"spec": torch.empty((1, t, spec_ch)),
                     "spec_lengths": torch.tensor([t]),
                     "ssl": torch.empty((1, t, cfg["model"]["ssl_dim"])),
                     "text": torch.zeros((1, tt), dtype=torch.long),
                     "text_lengths": torch.tensor([tt])}
            mel = torch.empty((spec_ch, cfg["data"]["n_mel_channels"]))
            ref.log_mel(batch["spec"], mel)
            ge = ref.style(G, batch["spec"], torch.ones((1, t, 1)),
                           ref.FP32).transpose(1, 2)
            h = ref.conv(G, "ssl_proj", batch["ssl"].transpose(1, 2),
                         ref.FP32, stride=2)
            qz = torch.repeat_interleave(h, 2, dim=2)
            m_p, logs_p, mask = ref.text_encoder(
                G, cfg, qz, batch["spec_lengths"], batch["text"],
                batch["text_lengths"], ge, ref.FP32, None)
            z, _, logs_q = ref.posterior(G, batch["spec"].transpose(1, 2),
                                         mask, ge, torch.empty((1, inter, t)),
                                         ref.FP32)
            z_p = ref.flow(G, z, mask, ge, ref.FP32)
            kl = (logs_p - logs_q + (z_p - m_p) ** 2).sum()
            used = [v for v in G.values() if v.requires_grad]
            torch.autograd.grad(kl, used, allow_unused=True)
        return costs.count_flops(run)

    def back():
        def run():
            G, D = params(gs), params(ds)
            z = torch.empty((1, inter, seg // hop), requires_grad=True)
            ge = torch.empty((1, cfg["model"]["gin_channels"], 1),
                             requires_grad=True)
            y_hat = ref.decoder(G, cfg, z, ge, ref.FP32)
            y = torch.empty((1, 1, seg))
            ref.grads_of(ref.disc_loss(D, y, y_hat.detach(), ref.FP32), D)
            _, fmap_r = ref.discriminate(D, y, ref.FP32)
            fake, fmap_g = ref.discriminate(
                {k: v.detach() for k, v in D.items()}, y_hat, ref.FP32)
            mel = torch.empty((spec_ch, cfg["data"]["n_mel_channels"]))
            spec = ref.spectrogram(y_hat[:, 0], cfg["data"]["filter_length"],
                                   hop, cfg["data"]["win_length"])
            loss = ref.log_mel(spec, mel).sum() + sum(
                f.sum() for f in fake) + sum(g.sum() for d in fmap_g
                                             for g in d)
            torch.autograd.grad(loss, [z, ge] + [G[k] for k in G if
                                                 k.startswith("dec.")])
        return costs.count_flops(run)

    terms = [lambda t, x: 1, lambda t, x: t, lambda t, x: t * t,
             lambda t, x: x, lambda t, x: x * x, lambda t, x: t * x]
    fits = costs.cached(cfg, [ref.__file__, costs.__file__, __file__],
                        lambda: {
        "fixed": [str(back())],
        "grow": costs.coef_strings(costs.PolyFlops(
            terms, front, [(40, 8), (48, 8), (56, 8), (40, 12), (40, 16),
                           (48, 12), (64, 20)]))})
    fixed = int(fits["fixed"][0])
    grow = costs.PolyFlops(terms, coef=fits["grow"])
    return lambda t, tt: fixed + grow(t, tt)


class Driver(TrainDriver):
    rate_metric = "s2_audio_s_per_s"
    program_state = ("step_fn", "dataset")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        super().__init__(cfg, traffic, seed, device)
        self.n_ref = self.check_cfg["steps"]
        d = cfg["data"]
        self.hop, self.sr = d["hop_length"], d["sampling_rate"]
        self.frame_hz = self.sr / self.hop

    # ---- the dataset folder ------------------------------------------------

    def _write_dataset(self, root: str) -> None:
        torch = self.torch
        items = traffic_mod.items(self.traffic, self.seed)
        table = traffic_mod.symbols()
        frames = [max(2, int(round(it.seconds * self.frame_hz)))
                  for it in items]
        s = sub_seed(self.seed, TAG_TRAFFIC + 100)
        # speech-like level: N(0, 0.1) of full scale, in int16
        wav = traffic_mod.random_normal(torch, sum(frames) * self.hop, s,
                                        self.device, torch.float32)
        wav = np.clip(np.round(wav * 0.1 * 32768), -32768, 32767).astype(
            "<i2")
        dim = self.cfg["model"]["ssl_dim"]
        ssl = traffic_mod.random_normal(torch, sum(frames) * dim, s + 1,
                                        self.device, torch.float16)
        for sub in ("4-cnhubert", "5-wav32k"):
            os.makedirs(os.path.join(root, sub))
        lines = []
        self.raw: Dict[str, dict] = {}
        at_w = at_s = 0
        for it, n in zip(items, frames):
            name = it.name + ".wav"
            w = wav[at_w:at_w + n * self.hop]
            f = ssl[at_s:at_s + n * dim].reshape(n, dim)
            at_w += n * self.hop
            at_s += n * dim
            with wave.open(os.path.join(root, "5-wav32k", name), "wb") as out:
                out.setnchannels(1)
                out.setsampwidth(2)
                out.setframerate(self.sr)
                out.writeframes(w.tobytes())
            np.save(os.path.join(root, "4-cnhubert", name + ".npy"), f)
            lines.append("\t".join([name, " ".join(table[i] for i in
                                                   it.phonemes),
                                    " ".join(["1"] * len(it.phonemes)), "x"]))
            self.raw[name] = {"wav": w, "ssl": f, "phonemes": it.phonemes}
        with open(os.path.join(root, "2-name2text.txt"), "w",
                  encoding="utf8") as out:
            out.write("\n".join(lines) + "\n")

    # ---- set-up -------------------------------------------------------------

    def setup(self) -> None:
        torch = self.torch
        from easevoice_trainer_tpu_torch.models.sovits import \
            MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
        from easevoice_trainer_tpu_torch.ops.stft import MelConfig
        from easevoice_trainer_tpu_torch.train import data as data_mod
        from easevoice_trainer_tpu_torch.train.sovits import SovitsTrain
        from easevoice_trainer_tpu_torch.train.sovits_step import S2TrainHP, \
            S2TrainStep

        cfg, d, t = self.cfg, self.cfg["data"], self.cfg["train"]
        self.tmp = tempfile.TemporaryDirectory(prefix="evbench-s2-")
        self._write_dataset(self.tmp.name)
        self.mark("dataset written")
        flops = flop_model(cfg)
        self.item_flops = {name: flops(len(r["wav"]) // self.hop,
                                       len(r["phonemes"]))
                           for name, r in self.raw.items()}
        self.dataset = data_mod.S2Dataset(
            self.tmp.name, hop_length=self.hop, sampling_rate=self.sr,
            n_fft=d["filter_length"], win_length=d["win_length"])
        self.collate = data_mod.collate_s2
        self.batcher = data_mod.BucketBatcher(
            self.dataset.lengths, self.traffic["batch_size"],
            seed=sub_seed(self.seed, TAG_ORDER, 31))
        self.steps_per_epoch = max(len(self.batcher.epoch_batches(0)), 1)
        self.text_cap = round_up(max(len(e.phoneme_ids)
                                     for e in self.dataset.examples), 16)
        self.to_device = lambda b: SovitsTrain._to_device(self, b)
        with torch.device(self.device):
            net_g = SynthesizerTrn(SovitsConfig.from_json_dict(cfg),
                                   with_enc_q=True, dtype=self.dtype)
            net_d = MultiPeriodDiscriminator(dtype=self.dtype)
        net_g.to(self.device)
        net_d.to(self.device)
        G, D = self.initial()
        net_g.load_state_dict(G, strict=True)
        net_d.load_state_dict(D, strict=True)
        del G, D
        hp = S2TrainHP(
            learning_rate=t["learning_rate"], betas=tuple(t["betas"]),
            eps=t["eps"], lr_decay=t["lr_decay"],
            segment_size=t["segment_size"], c_mel=t["c_mel"],
            c_kl=t["c_kl"], text_low_lr_rate=t["text_low_lr_rate"])
        mel_cfg = MelConfig(
            sampling_rate=self.sr, n_fft=d["filter_length"],
            hop_length=self.hop, win_length=d["win_length"],
            n_mels=d["n_mel_channels"], fmin=d["mel_fmin"],
            fmax=d["mel_fmax"])
        self.step_fn = S2TrainStep(net_g, net_d, hp, mel_cfg,
                                   steps_per_epoch=self.steps_per_epoch)
        self.gen = torch.Generator(device=self.device)
        self.draws = torch.Generator(device=self.device)
        self.draws.manual_seed(sub_seed(self.seed, TAG_STEP))
        self.mark("model built")
        self.stream = self._stream(self.batcher)
        buckets = {b for b, idx in enumerate(self.batcher.buckets) if idx}
        seen = set()
        self.prefix_losses = []
        while len(self.records) < self.n_ref or not buckets <= seen:
            seen.add(self.run_step()["bucket"])
        self.prefix = self.records[:self.n_ref]
        self.records = []

    def initial(self):
        return (make_weights(ref.generator_shapes(self.cfg), self.seed,
                             self.device, ref.init_rule),
                make_weights(ref.discriminator_shapes(self.cfg),
                             self.seed + 1, self.device))

    # ---- one step -----------------------------------------------------------

    def load(self):
        torch = self.torch
        bucket, idxs = next(self.stream)
        frames = self.batcher.padded_frames(bucket)
        items = [self.dataset.load_item(i) for i in idxs]
        batch = self.collate(items, frames, self.text_cap, hop=self.hop)
        dev = self.to_device(batch)
        names = [it["name"] for it in items]
        lengths = batch["spec_lengths"].tolist()
        seg = self.cfg["train"]["segment_size"] // self.hop
        # the step's draws: slice starts as the program draws them, the
        # posterior noise, and its dropout generator's seed
        b = len(names)
        u = torch.rand((b,), generator=self.draws, device=self.device)
        max_start = (dev["spec_lengths"] - seg + 1).clamp_min(1).float()
        ids_slice = (u * max_start).to(torch.int64)
        eps = torch.randn((b, frames, self.cfg["model"]["inter_channels"]),
                          generator=self.draws, device=self.device)
        rec = {"bucket": bucket, "names": names, "frames": frames,
               "lengths": lengths, "audio_s": sum(lengths) / self.frame_hz,
               "flops": sum(self.item_flops[n] for n in names),
               # the trainer seeds the step's generator so
               "gen_seed": (self.seed * 1_000_003 + self.step_fn.step)
               % (1 << 63),
               "mrf": self.mrf_calls(b)}
        if self.prefix is None and len(self.records) < self.n_ref:
            rec["ids_slice"], rec["eps"] = ids_slice, eps
        return (dev, ids_slice, eps), rec

    def mrf_calls(self, b: int) -> List[tuple]:
        """The ResBlock convs of one generator pass: (b, ch, t, k,
        residual) each."""
        m = self.cfg["model"]
        t = self.cfg["train"]["segment_size"] // self.hop
        ch = m["upsample_initial_channel"]
        calls = []
        for i, u in enumerate(m["upsample_rates"]):
            ch //= 2
            t *= u
            for rk, rd in zip(m["resblock_kernel_sizes"],
                              m["resblock_dilation_sizes"]):
                for _ in rd:
                    calls += [(b, ch, t, rk, False), (b, ch, t, rk, True)]
        return calls

    def step(self, batch, rec):
        dev, ids_slice, eps = batch
        self.gen.manual_seed(rec["gen_seed"])
        return self.step_fn(dev, self.gen, ids_slice=ids_slice, eps=eps)

    def after_step(self, rec: dict, metrics: dict) -> None:
        k = len(self.records) + 1      # the set-up's steps come first
        if self.prefix is not None or k > self.n_ref:
            return
        self.prefix_losses.append((float(metrics["loss/g/total"]),
                                   float(metrics["loss/d/total"])))
        log(f"program step {k}: " + ", ".join(
            f"{n} {float(v):.6g}" for n, v in metrics.items()))
        if k == 1:
            self.first_grads = self._grads_from_state()
        if k == self.n_ref:
            self.after = {
                **{k_: v.detach().float().cpu().clone() for k_, v in
                   self.step_fn.net_g.state_dict().items()},
                **{"D." + k_: v.detach().float().cpu().clone() for k_, v in
                   self.step_fn.net_d.state_dict().items()}}

    def _grads_from_state(self) -> Dict[str, float]:
        """Each leaf's norm of the gradient AdamW took at its first step,
        from its state: m = (1 - beta1) g."""
        out = {}
        b1 = self.step_fn.optim_g.b1
        for prefix, net, opt in (("", self.step_fn.net_g,
                                  self.step_fn.optim_g),
                                 ("D.", self.step_fn.net_d,
                                  self.step_fn.optim_d)):
            for name, p in net.named_parameters():
                if p.requires_grad:   # no state: the step took no gradient
                    m = opt.state.get(p)
                    out[prefix + name] = 0.0 if m is None else float(
                        m["m"].float().norm()) / (1.0 - b1)
        return out

    # ---- the check ----------------------------------------------------------

    def ref_batch(self, rec: dict) -> dict:
        """The step's batch from the raw clips: each clip's spectrogram
        worked out again from its waveform, all zero-padded to the step's
        frames."""
        torch = self.torch
        d = self.cfg["data"]
        b, n = len(rec["names"]), rec["frames"]
        dev = self.device
        wav = torch.zeros((b, n * self.hop), device=dev)
        ssl = torch.zeros((b, n, self.cfg["model"]["ssl_dim"]), device=dev)
        text = torch.zeros((b, self.text_cap), dtype=torch.long, device=dev)
        spec = torch.zeros((b, n, d["filter_length"] // 2 + 1), device=dev)
        lengths, tl = [], []
        for i, name in enumerate(rec["names"]):
            raw = self.raw[name]
            w = torch.from_numpy(raw["wav"].astype(np.float32) / 32768.0)
            wav[i, :len(w)] = w.to(dev)
            spec[i, :len(w) // self.hop] = ref.spectrogram(
                w[None].to(dev), d["filter_length"], self.hop,
                d["win_length"])[0]
            ssl[i, :raw["ssl"].shape[0]] = torch.from_numpy(
                raw["ssl"].astype(np.float32)).to(dev)
            ph = torch.from_numpy(raw["phonemes"])
            text[i, :len(ph)] = ph.to(dev)
            lengths.append(len(w) // self.hop)
            tl.append(len(ph))
        lengths = torch.tensor(lengths, device=dev)
        return {"wav": wav, "ssl": ssl, "spec": spec, "spec_lengths": lengths,
                "text": text, "text_lengths": torch.tensor(tl, device=dev)}

    def follow(self, q=ref.FP32, half_rows: bool = False) -> dict:
        """The reference over the set-up's first steps: their G and D
        losses, the first step's gradient norms by leaf (both nets), and
        both nets after the last step.  ``q`` rounds its products (a
        control); ``half_rows`` leaves out half of each batch (the losses
        are means, so the rest's mean stands for the batch's: a fault)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        G, D = self.initial()
        step = ref.Step(self.cfg, G, D, self.steps_per_epoch, q)
        losses, first = [], None
        gen = torch.Generator(device=self.device)
        for rec in self.prefix:
            batch = self.ref_batch(rec)
            ids_slice, eps = rec["ids_slice"], rec["eps"]
            if half_rows:
                n = len(rec["names"]) // 2
                batch = {k: v[:n] for k, v in batch.items()}
                ids_slice, eps = ids_slice[:n], eps[:n]
            gen.manual_seed(rec["gen_seed"])
            out = step(batch, ids_slice, eps, gen)
            losses.append((out["loss_g"], out["loss_d"]))
            log(f"reference step {len(losses)}: g {out['loss_g']:.6g}, d "
                f"{out['loss_d']:.6g}, " + ", ".join(
                    f"{n} {v:.6g}" for n, v in out["parts"].items()))
            if first is None:
                first = {**out["grads_g"], **{"D." + k: v for k, v in
                                              out["grads_d"].items()}}
        params = {**G, **{"D." + k: v for k, v in D.items()}}
        return {"losses": losses, "params": params,
                "first_grad_tensors": first,
                "first_grads": leaf_norms(torch, first)}

    def numbers(self, program: dict, reference: dict) -> Dict[str, float]:
        G0, D0 = self.initial()
        start = {**G0, **{"D." + k: v for k, v in D0.items()}}
        masks = compare.moving_masks(reference["first_grad_tensors"])
        ref_change = compare.masked_change_norms(reference["params"], start,
                                                 masks, self.device)
        prog_change = compare.masked_change_norms(program["params"], start,
                                                  masks, self.device)
        flat = lambda pairs: [x for pair in pairs for x in pair]
        log_loss_gaps(flat(program["losses"]), flat(reference["losses"]))
        log_worst("grad_gap", program["first_grads"],
                  reference["first_grads"])
        log_worst("change_gap", prog_change, ref_change)
        return {
            "loss_gap": compare.loss_gap(flat(program["losses"]),
                                         flat(reference["losses"])),
            "grad_gap": compare.leaf_gap(program["first_grads"],
                                         reference["first_grads"]),
            "change_gap": compare.leaf_gap(prog_change, ref_change),
        }

    def program_result(self) -> dict:
        return {"losses": self.prefix_losses,
                "first_grads": self.first_grads, "params": self.after}
