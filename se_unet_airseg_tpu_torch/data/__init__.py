from .splits import load_json_file, write_split_json
from .tiling import pad_positions_to_batch, tile_positions

__all__ = ["load_json_file", "pad_positions_to_batch", "tile_positions", "write_split_json"]
