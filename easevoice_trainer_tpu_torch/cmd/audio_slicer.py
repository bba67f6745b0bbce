"""cmd: silence slicing on the port (the service is built on one CUDA card
unless the params name ``"device": "cpu"``; slicing itself is host work)."""
from . import run_task


def main(params: dict):
    from ..service.audio import AudioService

    service = AudioService(params["source_dir"], params["output_dir"],
                           params.get("device", "cuda"))
    kwargs = {k: params[k] for k in
              ("threshold", "min_length", "min_interval", "hop_size",
               "max_silent_kept", "normalize_max", "alpha_mix")
              if k in params}
    return service.slicer(**kwargs)


if __name__ == "__main__":
    run_task(main)
