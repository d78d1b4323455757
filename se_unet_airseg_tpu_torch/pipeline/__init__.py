"""CT preprocessing (host code, numpy)."""

from .preprocess import preprocess_ct, preprocess_mask

__all__ = ["preprocess_ct", "preprocess_mask"]
