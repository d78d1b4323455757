"""Volume I/O: a self-contained NIfTI-1 codec."""

from .nifti import NiftiVolume, read_nifti, write_nifti

__all__ = ["NiftiVolume", "read_nifti", "write_nifti"]
