"""cmd: UVR5 vocal separation on the port (one CUDA card unless the params
name ``"device": "cpu"``); the JAX cmd's params: source_dir, output_dir,
model_name (default ``HP5_only_main_vocal``), audio_format."""
from . import run_task


def main(params: dict):
    from ..service.audio import AudioService

    service = AudioService(params["source_dir"], params["output_dir"],
                           params.get("device", "cuda"))
    return service.uvr5(model_name=params.get("model_name",
                                              "HP5_only_main_vocal"),
                        audio_format=params.get("audio_format", "wav"))


if __name__ == "__main__":
    run_task(main)
