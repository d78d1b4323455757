from .tiling import pad_positions_to_batch, tile_positions

__all__ = ["tile_positions", "pad_positions_to_batch"]
