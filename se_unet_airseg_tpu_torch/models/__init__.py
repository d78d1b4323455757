from .se_unet import (
    SEUNet,
    SEUNetConfig,
    apply as se_unet_apply,
    apply_fast as se_unet_apply_fast,
    get_model,
    num_params,
    prepare_fast_params,
)
from .swin_unetr import SwinUNETRConfig, apply as swin_unetr_apply
from .torch_import import (
    jax_params_from_torch,
    load_torch_checkpoint,
    params_from_state_dict,
    state_dict_from_jax_params,
)

__all__ = [
    "SEUNet",
    "SEUNetConfig",
    "SwinUNETRConfig",
    "get_model",
    "jax_params_from_torch",
    "load_torch_checkpoint",
    "num_params",
    "params_from_state_dict",
    "prepare_fast_params",
    "se_unet_apply",
    "se_unet_apply_fast",
    "state_dict_from_jax_params",
    "swin_unetr_apply",
]
