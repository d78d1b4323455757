"""Volume I/O: a self-contained NIfTI-1 codec."""

from .nifti import NiftiVolume, nifti_shape, read_nifti, write_nifti

__all__ = ["NiftiVolume", "nifti_shape", "read_nifti", "write_nifti"]
