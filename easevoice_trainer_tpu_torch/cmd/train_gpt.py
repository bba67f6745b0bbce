"""cmd: s1 GPT fine-tune on the port (one CUDA card unless the params name
``"device": "cpu"``).  When ``EASEVOICE_DP`` and ``EASEVOICE_TP`` give a
grid of more than one rank (``parallel/mesh.py train_world``), the task
starts this host's ranks, one process each (``parallel.distributed.launch``
with the grid's model axis), and answers with rank 0's response; rank 0
alone writes the progress lines."""
from . import filter_fields, run_task


def main(params: dict):
    from ..parallel import distributed, host_ranks, train_world
    from ..train.gpt import GPTTrainParams, train_gpt

    p = GPTTrainParams(**filter_fields(params, GPTTrainParams))
    grid = train_world(p.device)
    if grid is None:
        return train_gpt(p)
    return distributed.launch(train_gpt, (p,), host_ranks(grid),
                              device=p.device, n_model=grid[1])[0]


if __name__ == "__main__":
    run_task(main)
