"""Device resolution for the port's entry points, and the machine's cards.

The port's hot path is CUDA: an entry point that was given no device
runs on the GPU, and raises when there is none rather than carrying on
quietly on the CPU. Tests and CPU debugging pass `device="cpu"`. Under
a mesh (`parallel.make_mesh`) `None` is the rank's own CUDA device.

`pick_devices` and `device_summary` are the counterparts of the JAX
package's `utils/devices.py`; `pick_devices` reads each card's free
memory (`torch.cuda.mem_get_info`), which the reference polled with
pynvml (reference util.py:78-91, test.py:273-283, weight_br.py:208-240).
"""

from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """`None` -> `cuda`, or the rank's device `mesh.device` under a mesh
    (raises without CUDA); anything else is taken as given (`"cpu"`,
    `"cuda:1"`, a `torch.device`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda") if mesh is None else mesh.device
    return torch.device(device)


def pick_devices(n: int = 1, min_hbm_gb: float = 0.0) -> list[torch.device]:
    """The first `n` CUDA devices with at least `min_hbm_gb` GB (1e9
    bytes) of free memory, in index order; raises RuntimeError without
    CUDA or when fewer qualify."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"need {n} CUDA devices, have none")
    free = [torch.cuda.mem_get_info(i)[0] for i in range(torch.cuda.device_count())]
    ok = [torch.device("cuda", i) for i, f in enumerate(free) if f >= min_hbm_gb * 1e9]
    if len(ok) < n:
        raise RuntimeError(f"need {n} CUDA devices with {min_hbm_gb} GB free, have "
                           f"{len(ok)} of {len(free)} (free GB: "
                           f"{', '.join(f'{f / 1e9:.1f}' for f in free)})")
    return ok[:n]


def device_summary() -> str:
    """Each CUDA device's index, name, free and total GB, on one line;
    "cpu" without CUDA. It describes the machine and selects nothing."""
    if not torch.cuda.is_available():
        return "cpu"
    lines = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"cuda:{i} {torch.cuda.get_device_name(i)} "
                     f"{free / 1e9:.1f}/{total / 1e9:.1f} GB free")
    return ", ".join(lines)
