from .t2s import Text2SemanticDecoder, T2SConfig
from .decode import decode_ar, DecodeParams
