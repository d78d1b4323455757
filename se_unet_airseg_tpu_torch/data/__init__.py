from .augment import augment_crops
from .datasets import OnlineCrops, Prefetcher, Stage1Crops, Stage2Crops, Stage3Crops
from .splits import load_json_file, write_split_json
from .tiling import pad_positions_to_batch, tile_positions

__all__ = [
    "OnlineCrops",
    "Prefetcher",
    "Stage1Crops",
    "Stage2Crops",
    "Stage3Crops",
    "augment_crops",
    "load_json_file",
    "pad_positions_to_batch",
    "tile_positions",
    "write_split_json",
]
