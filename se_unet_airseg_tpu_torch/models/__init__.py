from .se_unet import (
    SEUNet,
    SEUNetConfig,
    apply as se_unet_apply,
    apply_fast as se_unet_apply_fast,
    get_model,
    prepare_fast_params,
)
from .torch_import import (
    load_torch_checkpoint,
    params_from_state_dict,
    state_dict_from_jax_params,
)

__all__ = [
    "SEUNet",
    "SEUNetConfig",
    "get_model",
    "load_torch_checkpoint",
    "params_from_state_dict",
    "prepare_fast_params",
    "se_unet_apply",
    "se_unet_apply_fast",
    "state_dict_from_jax_params",
]
