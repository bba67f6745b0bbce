"""cmd: s2 SoVITS fine-tune on the port (one CUDA card unless the params
name ``"device": "cpu"``)."""
from . import filter_fields, run_task


def main(params: dict):
    from ..train.sovits import SovitsTrain, SovitsTrainParams

    p = SovitsTrainParams(**filter_fields(params, SovitsTrainParams))
    return SovitsTrain(p).train()


if __name__ == "__main__":
    run_task(main)
