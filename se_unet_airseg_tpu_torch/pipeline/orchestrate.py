"""Full 3-stage curriculum orchestration (reference train.py:849-917).

Wires the stage drivers, prior generators and DTI re-validation into
the reference's end-to-end flow with the same on-disk layout:

  stage 1 -> ./data/pred_1 -> stage 2 -> best epoch (recall score)
  -> ./data/pred_2 -> BR_weight + br_skel -> stage 3
  -> DTI re-validation of stages 2 and 3.

Every path is a parameter with the reference default, so integration
tests point the whole pipeline at a tmp directory with synthetic
volumes.

Counterpart of the JAX package's `pipeline/orchestrate.py`: the same
hand-offs, through the port's parameter files (`SE_UNet_<ep>.pt`), on
`PipelineConfig.device` (default None: `cuda`, raising without CUDA).

On a mesh (`PipelineConfig.mesh`, a `parallel.DataMesh`) every rank runs
this function: the stage drivers train over the ranks, and the priors
(`save_stage_pred`, `save_weight_break`) and the DTI re-validations split
the cases over the ranks, with a barrier before any rank reads what
another wrote. No rank waits in a collective while another works
through a whole split (`parallel/mesh.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from ..data.splits import load_json_file
from ..models.se_unet import SEUNetConfig
from ..train.checkpoint import load_params
from ..train.logbook import best_epoch, best_epoch_recall
from ..train.stages import StageConfig, train_stage1, train_stage2, train_stage3
from .priors import save_stage_pred, save_weight_break


@dataclasses.dataclass
class PipelineConfig:
    data_root: str = "AFTER_DATA"
    file_root: str = "./data"
    saved_model: str = "./saved_model"
    log_dir: str = "./LOG"
    epochs: tuple[int, int, int] = (100, 50, 50)
    batch_size: int = 8
    cube: int = 128
    seed: int = 777
    # remat by default: on an H100 80GB HBM3 at 700 W a bf16 stage-1 step
    # of 8 crops of 128^3 peaks at 22.95 GB with remat, 29.70 GB without
    model_cfg: SEUNetConfig = dataclasses.field(
        default_factory=lambda: SEUNetConfig(remat=True)
    )
    mesh: object = None  # a parallel.DataMesh: the stages train over its ranks
    device: Any = None  # None -> cuda, the rank's under a mesh (raises without CUDA)


def run_full_curriculum(cfg: PipelineConfig):
    fp = os.path.join(cfg.file_root, "base_dict.json")
    if cfg.mesh is None or cfg.mesh.is_main:
        os.makedirs(cfg.log_dir, exist_ok=True)

    def barrier():
        if cfg.mesh is not None:
            cfg.mesh.barrier()

    def stage_cfg(stage: int, **kw) -> StageConfig:
        names = {1: "stage_one", 2: "stage_two", 3: "stage_three"}
        return StageConfig(
            data_root=cfg.data_root,
            file_root=cfg.file_root,
            file_path=fp,
            model_savepath=os.path.join(cfg.saved_model, names[stage]),
            log_savepath=os.path.join(cfg.log_dir, f"log_{names[stage]}.txt"),
            epochs=cfg.epochs[stage - 1],
            batch_size=cfg.batch_size,
            cube=cfg.cube,
            seed=cfg.seed,
            model_cfg=cfg.model_cfg,
            mesh=cfg.mesh,
            device=cfg.device,
            **kw,
        )

    # ---- stage 1 ----
    s1 = stage_cfg(1, milestones=(60, 90))
    state1 = train_stage1(s1)

    # ---- pred_1 over train+val (reference train.py:876) ----
    pred1_dir = os.path.join(cfg.file_root, "pred_1")
    save_stage_pred(state1.params, cfg.model_cfg, fp, cfg.data_root, pred1_dir,
                    cube=cfg.cube, step=cfg.cube // 2, device=cfg.device, mesh=cfg.mesh)
    barrier()

    # ---- stage 2 ----
    s2 = stage_cfg(
        2,
        milestones=(40, 60),
        pred_path=pred1_dir,
        online_savepath=os.path.join(cfg.file_root, "online_hardmining_stage_two"),
        start_params=os.path.join(s1.model_savepath, f"SE_UNet_{cfg.epochs[0] - 1}.pt"),
    )
    train_stage2(s2)

    # ---- best stage-2 epoch by recall score (reference train.py:891) ----
    ep2 = best_epoch_recall(s2.log_savepath)

    # ---- pred_2 + break priors (reference train.py:894-898) ----
    pred2_dir = os.path.join(cfg.file_root, "pred_2")
    br_weight_dir = os.path.join(cfg.file_root, "BR_weight")
    br_skel_dir = os.path.join(cfg.file_root, "br_skel")
    params2 = load_params(os.path.join(s2.model_savepath, f"SE_UNet_{ep2}.pt"))
    save_stage_pred(params2, cfg.model_cfg, fp, cfg.data_root, pred2_dir,
                    cube=cfg.cube, step=cfg.cube // 2, device=cfg.device, mesh=cfg.mesh)
    # the same split of the same cases: a rank reads the pred_2 it wrote
    save_weight_break(cfg.data_root, pred2_dir, br_weight_dir, br_skel_dir, fp, mesh=cfg.mesh)
    barrier()

    # ---- stage 3 ----
    s3 = stage_cfg(
        3,
        milestones=(40, 60),
        pred_path=pred2_dir,
        br_skel_path=br_skel_dir,
        br_weight_path=br_weight_dir,
        online_savepath=os.path.join(cfg.file_root, "online_hardmining_stage_three"),
        start_params=os.path.join(s2.model_savepath, f"SE_UNet_{ep2}.pt"),
    )
    train_stage3(s3)

    # ---- DTI re-validation (reference train.py:913-917) ----
    from ..infer.engine import validate

    names = load_json_file(fp, "0", ("val",))
    for stage, scfg, pick in ((2, s2, best_epoch_recall), (3, s3, best_epoch)):
        ep = pick(scfg.log_savepath)
        params = load_params(os.path.join(scfg.model_savepath, f"SE_UNet_{ep}.pt"))
        validate(
            params, cfg.model_cfg, names, cfg.data_root, cfg.file_root,
            ep, scfg.log_savepath + ".dti", dti=True, stage=stage,
            cube=cfg.cube, step=cfg.cube // 2, device=cfg.device, mesh=cfg.mesh,
        )
    barrier()
    return s3
