from .t5 import T5Config, T5EncoderModel
