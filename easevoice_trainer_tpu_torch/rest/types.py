"""Task-name and cmd-module registries (JAX: rest/types.py)."""


class TaskType:
    train_gpt = "train_gpt"
    train_sovits = "train_sovits"
    normalize = "normalize"
    audio_uvr5 = "audio_uvr5"
    audio_slicer = "audio_slicer"
    audio_denoise = "audio_denoise"
    audio_asr = "audio_asr"
    voice_clone = "voice_clone"
    ease_voice = "ease_voice"


class TaskCMD:
    """cmd module names under easevoice_trainer_tpu_torch.cmd."""

    train_gpt = "train_gpt"
    train_sovits = "train_sovits"
    normalize = "normalize"
    audio_uvr5 = "audio_uvr5"
    audio_slicer = "audio_slicer"
    audio_denoise = "audio_denoise"
    audio_asr = "audio_asr"
    ease_voice = "easy_mode"
