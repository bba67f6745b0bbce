"""cmd: dataset normalization on the port (one CUDA card unless the params
name ``"device": "cpu"``)."""
from . import filter_fields, run_task


def main(params: dict):
    from ..service.normalize import NormalizeParams, NormalizeService

    p = NormalizeParams(**filter_fields(params, NormalizeParams))
    service = NormalizeService(p.processing_path or p.output_dir,
                               p.predefined_output_path, p.device)
    return service.run()


if __name__ == "__main__":
    run_task(main)
