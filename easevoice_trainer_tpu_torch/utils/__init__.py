from .response import EaseVoiceResponse, ResponseStatus
from .logger import get_logger, logger
