from .encoding import Encoding, PathEncoder, decode_segments
from .config import Capacities, RenderParams, TILE_H, TILE_W
from .resolve import ResolvedScene, resolve
