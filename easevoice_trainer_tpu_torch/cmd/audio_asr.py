"""cmd: ASR transcription on the port (one CUDA card unless the params name
``"device": "cpu"``): fsmn-VAD -> Paraformer -> CT-punc for zh, Whisper for
the other languages; writes ``asrs/asr.list`` and the refinement dump."""
from . import run_task


def main(params: dict):
    from ..service.audio import AudioService

    service = AudioService(params["source_dir"], params["output_dir"],
                           params.get("device", "cuda"))
    return service.asr(asr_model=params.get("asr_model", "funasr"),
                       model_size=params.get("model_size", "large"),
                       language=params.get("language", "zh"),
                       precision=params.get("precision", "float32"))


if __name__ == "__main__":
    run_task(main)
