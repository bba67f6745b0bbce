"""cmd: denoise on the port (one CUDA card unless the params name
``"device": "cpu"``)."""
from . import run_task


def main(params: dict):
    from ..service.audio import AudioService

    service = AudioService(params["source_dir"], params["output_dir"],
                           params.get("device", "cuda"))
    return service.denoise()


if __name__ == "__main__":
    run_task(main)
