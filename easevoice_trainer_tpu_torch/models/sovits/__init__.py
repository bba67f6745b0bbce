from .synthesizer import SynthesizerTrn, SovitsConfig
from .quantize import ResidualVectorQuantizer
