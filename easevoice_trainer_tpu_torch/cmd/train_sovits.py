"""cmd: s2 SoVITS fine-tune on the port (one CUDA card unless the params
name ``"device": "cpu"``).  When ``EASEVOICE_DP`` gives this host more than
one rank (``parallel/mesh.py data_parallel_world``), the task starts one
process a rank (``parallel.distributed.launch``) and answers with rank 0's
response; rank 0 alone writes the progress lines.  ``EASEVOICE_TP`` is not
read: the s2 fine-tune is data-parallel only, as the JAX package's."""
from . import filter_fields, run_task


def main(params: dict):
    from ..parallel import data_parallel_world, distributed
    from ..train.sovits import SovitsTrainParams, train_sovits

    p = SovitsTrainParams(**filter_fields(params, SovitsTrainParams))
    ranks = data_parallel_world(p.device)
    if ranks is None:
        return train_sovits(p)
    return distributed.launch(train_sovits, (p,), ranks, device=p.device)[0]


if __name__ == "__main__":
    run_task(main)
