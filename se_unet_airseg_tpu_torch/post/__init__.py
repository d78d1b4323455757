"""Host post-processing: connected components, double-threshold
iteration, skeleton, hole filling (`_native`, the native library with
scipy fallbacks) and the STL export (`post.mesh`)."""

from ._native import (
    component_counts,
    connected_components,
    dti,
    fill_holes,
    largest_component,
    native_available,
    skeletonize_3d,
)

__all__ = [
    "component_counts",
    "connected_components",
    "dti",
    "fill_holes",
    "largest_component",
    "native_available",
    "skeletonize_3d",
]
