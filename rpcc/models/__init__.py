"""Device encoder/decoder graphs and the host compression pipeline."""

from rpcc.models.encoder import make_encoder, EncoderOutput
from rpcc.models.decoder import make_decoder
