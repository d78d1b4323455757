from .sliding_window import SlidingWindowRunner

__all__ = ["SlidingWindowRunner"]
