"""Host post-processing: connected components, double-threshold
iteration, skeleton, hole filling, morphology, EDT with nearest-zero
indices, label boxes and the 3^3 box sum (`_native`, the native library
with scipy fallbacks). The higher layers are imported as submodules:
`post.topology` (the "Ours" tree parser), `post.atm22` (the ATM22
parser), `post.regrade` (anatomical labels), `post.mesh` (the STL
export) and `post.render` (centerline and parse-map figures)."""

from ._native import (
    binary_closing,
    binary_dilation,
    box_convolve27,
    component_counts,
    connected_components,
    dti,
    edt_with_indices,
    fill_holes,
    find_objects,
    largest_component,
    native_available,
    skeletonize_3d,
)

__all__ = [
    "binary_closing",
    "binary_dilation",
    "box_convolve27",
    "component_counts",
    "connected_components",
    "dti",
    "edt_with_indices",
    "fill_holes",
    "find_objects",
    "largest_component",
    "native_available",
    "skeletonize_3d",
]
