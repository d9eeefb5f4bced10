from .encoding import Encoding, PathEncoder, decode_segments
