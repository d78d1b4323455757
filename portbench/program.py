"""What the benchmark takes from the program under test, in one place.

The program is the PyTorch/CUDA package `se_unet_airseg_tpu_torch`; the
benchmark builds its model configuration, hands it the weights and inputs
it made itself, and reads its kernel launch counters. The names taken:
  * `models.se_unet.SEUNetConfig`, `models.torch_import.params_from_state_dict`;
  * `infer.sliding_window.SlidingWindowRunner` (`predict_trits`,
    `predict_trits_summary_device`) and `fetch_trits`;
  * `train.step.make_optimizer`, `create_train_state`, `make_resilient_step`,
    `set_learning_rate`;
  * `train.stages._epoch_pass` (private: the stage drivers' epoch loop);
  * `data.datasets.Stage1Crops`, `Prefetcher`;
  * `ops.cuda_lib.launch_counts`, `reset_launch_counts`.
"""

from __future__ import annotations

import torch

from se_unet_airseg_tpu_torch.data.datasets import Prefetcher, Stage1Crops  # noqa: F401
from se_unet_airseg_tpu_torch.infer.sliding_window import (  # noqa: F401
    SlidingWindowRunner,
    fetch_trits,
)
from se_unet_airseg_tpu_torch.models.se_unet import SEUNetConfig
from se_unet_airseg_tpu_torch.models.torch_import import params_from_state_dict  # noqa: F401
from se_unet_airseg_tpu_torch.ops.cuda_lib import launch_counts, reset_launch_counts  # noqa: F401
from se_unet_airseg_tpu_torch.train.stages import _epoch_pass  # noqa: F401
from se_unet_airseg_tpu_torch.train.step import (  # noqa: F401
    create_train_state,
    make_optimizer,
    make_resilient_step,
    set_learning_rate,
)


def model_config(conf: dict) -> SEUNetConfig:
    """The program's configuration from a configuration file's settings."""
    return SEUNetConfig(in_channels=conf["in_channels"], n_classes=conf["n_classes"],
                        side_channels=conf["side_channels"],
                        drop_threshold=conf["drop_threshold"],
                        compute_dtype=getattr(torch, conf["compute_dtype"]),
                        remat=conf["remat"], conv_stats=conf["conv_stats"],
                        conv_epi=conf["conv_epi"])


def leaf_names(tree: dict, sd: dict) -> dict:
    """{path: state_dict name} of a parameter tree made from `sd` by
    `params_from_state_dict` (whose leaves are views of sd's tensors)."""
    by_ptr = {t.data_ptr(): n for n, t in sd.items()}
    return {path: by_ptr[leaf.data_ptr()] for path, leaf in walk(tree)}


def walk(tree: dict, prefix: tuple = ()):
    """(path, leaf) of a parameter tree, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v
