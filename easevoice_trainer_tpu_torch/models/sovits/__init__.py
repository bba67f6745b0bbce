from .synthesizer import SynthesizerTrn, SovitsConfig
from .quantize import ResidualVectorQuantizer
from .discriminator import MultiPeriodDiscriminator
