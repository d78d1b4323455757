"""CT preprocessing (host code, numpy), the priors written between the
curriculum's stages (`pipeline.priors`) and the 3-stage flow
(`pipeline.orchestrate`)."""

from .preprocess import preprocess_ct, preprocess_mask

__all__ = ["preprocess_ct", "preprocess_mask"]
