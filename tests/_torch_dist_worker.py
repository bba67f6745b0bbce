"""Worker of tests/test_torch_distributed.py: a data-parallel world of the
port on the CPU, its ranks started by ``parallel.distributed.launch`` over
gloo, each running the s1 or s2 train step on its rows of the global
batches that the spec file holds.

    python tests/_torch_dist_worker.py <spec.pt> <out.pt> <ranks>

The spec file (``torch.save``'d by the test) holds a list of runs, each
with its mode ("s1" or "s2"), the model config and weights, the global
batches as numpy and the seed.  ``out.pt`` gets every rank's list of
:func:`run` results, in rank order, the world of one's (:func:`run` with
``rows=None`` on the global batches, in this process) and the error of a
second launch in which rank 1 raises.  Every process computes on one
thread.
"""
import hashlib
import os
import sys

import numpy as np
import torch


def _tensors(batch, rows):
    """The rows ``rows`` of a numpy batch as tensors (int64 ids)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
        torch.int64 if v.dtype.kind == "i" else torch.float32)
        for k, v in batch.items()}


def _digest(modules) -> str:
    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run(spec: dict, rows):
    """One rank's steps (``rows``: its ``BatchRows``, or None for the world
    of one on the global batches) -> {"metrics": one dict a step,
    "state": the weights after, "digest": their sha256}."""
    from easevoice_trainer_tpu_torch.parallel import distributed

    n = next(iter(spec["batches"][0].values())).shape[0]
    local = list(range(n)) if rows is None else \
        distributed.process_local_rows(n)
    metrics = []
    if spec["mode"] == "s1":
        from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
            Text2SemanticDecoder
        from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
            GPTTrainStep

        model = Text2SemanticDecoder(T2SConfig(**spec["cfg"]))
        model.load_state_dict(spec["state"], strict=True)
        step = GPTTrainStep(model.train(), GPTTrainHP())
        for i, batch in enumerate(spec["batches"]):
            got = step(_tensors(batch, local), seed=spec["seed"] + i,
                       rows=rows)
            metrics.append({k: float(v) for k, v in got.items()})
        nets = (model,)
    else:
        from easevoice_trainer_tpu_torch.models.sovits import \
            MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
        from easevoice_trainer_tpu_torch.ops.stft import MelConfig
        from easevoice_trainer_tpu_torch.train.sovits_step import \
            S2TrainHP, S2TrainStep

        net_g = SynthesizerTrn(SovitsConfig(**spec["cfg"]), with_enc_q=True)
        net_g.load_state_dict(spec["state"], strict=True)
        net_d = MultiPeriodDiscriminator(spec["periods"])
        net_d.load_state_dict(spec["state_d"], strict=True)
        step = S2TrainStep(net_g, net_d, S2TrainHP(
            segment_size=spec["segment_size"], learning_rate=spec["lr"]),
            MelConfig(), steps_per_epoch=1)
        gen = torch.Generator()
        for i, batch in enumerate(spec["batches"]):
            gen.manual_seed(spec["seed"] + i)
            got = step(_tensors(batch, local), gen, rows=rows)
            metrics.append({k: float(v) for k, v in got.items()})
        nets = (net_g, net_d)
    return {"metrics": metrics, "state": [_state(m) for m in nets],
            "digest": _digest(nets)}


def _rank(spec_path: str):
    from easevoice_trainer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    out = []
    for spec in torch.load(spec_path, weights_only=False):
        n = next(iter(spec["batches"][0].values())).shape[0]
        out.append(run(spec, distributed.batch_rows(n)))
    return out


def _fail_on_rank_1():
    from easevoice_trainer_tpu_torch.parallel import distributed

    if distributed.rank() == 1:
        raise ValueError("rank 1 planted a failure")
    distributed.sum_across_ranks({"x": torch.ones(())})


def main() -> None:
    spec_path, out_path, ranks = sys.argv[1], sys.argv[2], int(sys.argv[3])
    from easevoice_trainer_tpu_torch.parallel import distributed

    results = distributed.launch(_rank, (spec_path,), ranks, device="cpu")
    # the world of one on the global batches, in this process
    torch.set_num_threads(1)
    one = [run(spec, None)
           for spec in torch.load(spec_path, weights_only=False)]
    # a rank that raises fails the launch, and the others are stopped
    try:
        distributed.launch(_fail_on_rank_1, (), ranks, device="cpu")
        failure = None
    except RuntimeError as e:
        failure = str(e)
    torch.save({"ranks": results, "one": one, "failure": failure},
               out_path + ".tmp")
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main()
