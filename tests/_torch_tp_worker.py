"""Worker of tests/test_torch_tensor_parallel.py: a (data, model) grid of
the port's ranks on the CPU, started by ``parallel.distributed.launch``
over gloo, each running Megatron's f and g and the s1 train step on its
rows of the global batches and its shard of the GPT.

    python tests/_torch_tp_worker.py <spec.pt> <out.pt> <n_data> <n_model>

The spec file (``torch.save``'d by the test) holds a list of runs: "fg"
(f and g around a column- and a row-parallel product) or "s1" (the model
config, its whole weights, the global batches as numpy, the dropout seed
and the step's hp).  ``out.pt`` gets every rank's list of :func:`run`
results, in rank order, and the world of one's (:func:`run` with no world,
in this process).  Every process computes on one thread.
"""
import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dist_worker import _tensors  # noqa: E402


def _fg(spec):
    """y = g(relu(f(x) W1_m^T) W2_m^T), loss sum(y c): (y, dx, dW1_m,
    dW2_m), W1 (F, D) sharded by rows and W2 (D, F) by columns."""
    from easevoice_trainer_tpu_torch.parallel import distributed
    from easevoice_trainer_tpu_torch.parallel.gpt_sharding import \
        copy_to_model, reduce_from_model

    gen = torch.Generator().manual_seed(spec["seed"])
    x, w1, w2, c = (torch.randn(s, generator=gen) for s in (
        (3, 5, 8), (12, 8), (8, 12), (3, 5, 8)))
    m, n = distributed.model_rank(), distributed.model_size()
    f = 12 // n
    x.requires_grad_(True)
    w1 = w1[m * f:(m + 1) * f].clone().requires_grad_(True)
    w2 = w2[:, m * f:(m + 1) * f].clone().requires_grad_(True)
    h = torch.relu(copy_to_model(x) @ w1.T) if n > 1 else \
        torch.relu(x @ w1.T)
    y = reduce_from_model(h @ w2.T) if n > 1 else h @ w2.T
    (y * c).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw1": w1.grad, "dw2": w2.grad}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for k, v in tensors:
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _s1(spec, rows):
    """One accumulation window -> {"metrics", "whole": the gathered
    parameters after it, "rep_digest": sha256 of the replicated
    parameters, "round_trip": whether the step's whole state loads into a
    fresh shard and comes back bit for bit, "grid": (rank, data index,
    model index, rows)}."""
    from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
        Text2SemanticDecoder
    from easevoice_trainer_tpu_torch.parallel import distributed, \
        gpt_sharding
    from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
        GPTTrainStep

    cfg = T2SConfig(**spec["cfg"])
    tp = None if distributed.model_size() == 1 else (
        distributed.model_rank(), distributed.model_size())

    def shard():
        model = Text2SemanticDecoder(cfg, tp=tp)
        state = spec["state"] if tp is None else \
            gpt_sharding.shard_state_dict(spec["state"], *tp)
        model.load_state_dict(state, strict=True)
        return model.train()

    n = next(iter(spec["batches"][0].values())).shape[0]
    local = distributed.process_local_rows(n)
    model = shard()
    hp = GPTTrainHP(**spec.get("hp", {}))
    step = GPTTrainStep(model, hp)
    metrics = []
    for i, batch in enumerate(spec["batches"]):
        got = step(_tensors(batch, local), seed=spec["seed"] + i, rows=rows)
        metrics.append({k: float(v) for k, v in got.items()})
    named = [(k, v.detach()) for k, v in model.state_dict().items()]
    whole = dict(zip([k for k, _ in named],
                     gpt_sharding.gather_whole(named)))
    state = step.state_dict()
    again = GPTTrainStep(shard(), hp)
    again.load_state_dict(state)
    return {"metrics": metrics, "whole": whole,
            "rep_digest": _digest([(k, v) for k, v in named
                                   if gpt_sharding.shard_class(k) == "rep"]),
            "round_trip": _same(state, again.state_dict()),
            "grid": (distributed.rank(), distributed.data_rank(),
                     distributed.model_rank(), local)}


def _same(a, b) -> bool:
    """Bitwise equality of two nested step states."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def run(spec: dict, rows):
    return _fg(spec) if spec["mode"] == "fg" else _s1(spec, rows)


def _rank(spec_path: str):
    from easevoice_trainer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    out = []
    for spec in torch.load(spec_path, weights_only=False):
        rows = None
        if spec["mode"] == "s1":
            n = next(iter(spec["batches"][0].values())).shape[0]
            rows = distributed.batch_rows(n)
        out.append(run(spec, rows))
    return out


def main() -> None:
    spec_path, out_path = sys.argv[1], sys.argv[2]
    n_data, n_model = int(sys.argv[3]), int(sys.argv[4])
    from easevoice_trainer_tpu_torch.parallel import distributed

    results = distributed.launch(_rank, (spec_path,), n_data * n_model,
                                 device="cpu", n_model=n_model)
    torch.set_num_threads(1)
    one = [run(spec, None)
           for spec in torch.load(spec_path, weights_only=False)]
    torch.save({"ranks": results, "one": one}, out_path + ".tmp")
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main()
