"""Checkpointing: per-epoch weight snapshots, full states for resume, and
the JAX package's parameter files.

The reference saves a bare state_dict every epoch per stage
(`saved_model/stage_*/SE_UNet_<ep>.pth`, reference train.py:322-324,
510-512, 625-627). The port keeps the cadence and naming
(`SE_UNet_<ep>.pt`) and stores its parameter tree (DHWIO tensors,
`torch.save`), which `SlidingWindowRunner` takes as it is. `load_params`
also reads reference `.pth` state_dicts (through
`models.load_torch_checkpoint`) and the JAX package's `.msgpack`
parameter files (flax's msgpack encoding, read by a decoder of the
port's own: the card's machine has neither flax nor msgpack), so a
model trained by either continues here.

`save_state` / `load_state` persist the parameters, the optimizer's
state and the step (`state_<ep>.pt`) for exact resume, which the
reference lacks (it restarts the optimizer on every resume).
`load_state` also reads the JAX package's full states
(`state_<ep>.msgpack`: the parameters, the optax AdamW state and the
step), so a run that the JAX drivers left resumes here.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..models.torch_import import (
    load_torch_checkpoint,
    params_from_state_dict,
    state_dict_from_jax_params,
)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu").contiguous()


def _paths(tree, prefix=()):
    """(path, leaf) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def save_params(params, model_dir: str, epoch: int) -> str:
    """Write the parameter tree to `<model_dir>/SE_UNet_<epoch>.pt`;
    returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"SE_UNet_{epoch}.pt")
    torch.save(_to_host(params), path)
    return path


def load_params(path: str) -> dict:
    """Load a parameter tree (on the CPU) from a `.pt` file written by
    `save_params`, a reference `.pth` state_dict or a JAX package
    `.msgpack` parameter file (`SE_UNet_<ep>.msgpack`)."""
    if path.endswith(".pth"):
        return load_torch_checkpoint(path)
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        return _jax_tree(tree)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(arch: str, path: str, compute_dtype: torch.dtype):
    """(parameters, configuration) of the network `arch` (`se_unet`, or
    `swin_unetr`: a MONAI `SwinUNETR` state_dict at its published widths)
    from the checkpoint at `path`, for the runner and the CLIs."""
    if arch == "swin_unetr":
        from ..models.swin_unetr import SwinUNETRConfig, load_params as load_swin

        return load_swin(path), SwinUNETRConfig(compute_dtype=compute_dtype)
    if arch != "se_unet":
        raise ValueError(f"unknown network {arch!r}")
    from ..models.se_unet import SEUNetConfig

    return load_params(path), SEUNetConfig(compute_dtype=compute_dtype)


def save_state(state, model_dir: str, epoch: int) -> str:
    """Write `<model_dir>/state_<epoch>.pt`: the parameter tree, the
    optimizer's `state_dict()`, the step, and the parameter paths in the
    optimizer's order. Returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"state_{epoch}.pt")
    torch.save({"params": _to_host(state.params),
                "optimizer": state.optimizer.state_dict(),
                "order": [list(p) for p, _ in _paths(state.params)],
                "step": int(state.step)}, path)
    return path


def _copy_params(path: str, saved: dict, state) -> list:
    """Copy `saved` ({path: tensor}) into the state's parameter leaves;
    returns the state's paths in its optimizer's order."""
    order = [p for p, _ in _paths(state.params)]
    if sorted(order) != sorted(saved):
        raise ValueError(f"{path}: its parameter paths differ from the state's")
    with torch.no_grad():
        for p, leaf in _paths(state.params):
            leaf.copy_(saved[p])
    return order


def load_state(path: str, state):
    """Load a `save_state` file, or a JAX package `state_<ep>.msgpack`
    (`load_jax_state`), into `state` (a TrainState over a tree of the
    same paths) in place: its parameter leaves take the saved values,
    its optimizer the saved moments (matched by path, whatever the order
    of either tree), its step the saved step. Returns `state`."""
    if path.endswith(".msgpack"):
        return load_jax_state(path, state)
    data = torch.load(path, map_location="cpu", weights_only=True)
    order = _copy_params(path, {tuple(p): t for p, t in _paths(data["params"])}, state)
    # the saved state_dict keys the moments by the saved order; the
    # optimizer pairs its group's ids, position by position, with its own
    # parameters, which run in the state's order
    opt = data["optimizer"]
    (group,) = opt["param_groups"]
    saved_id = {tuple(p): group["params"][i] for i, p in enumerate(data["order"])}
    opt["param_groups"] = [{**group, "params": [saved_id[p] for p in order]}]
    state.optimizer.load_state_dict(opt)
    state.step = int(data["step"])
    return state


def _jax_tree(tree) -> dict:
    """A JAX-layout tree (parameters or one of their moments) as the
    port's tree: the leaf-wise bridge `load_params` applies."""
    return params_from_state_dict(state_dict_from_jax_params(tree))


def load_jax_state(path: str, state):
    """Load a JAX package full state (`state_<ep>.msgpack`: flax's
    encoding of its TrainState, whose optimizer state is
    `optax.inject_hyperparams(optax.adamw)`'s) into `state` in place.
    Mapped by parameter path: `params` to the leaves;
    `opt_state/inner_state/0/{mu, nu}` to each parameter's AdamW
    `exp_avg`, `exp_avg_sq`; that state's `count` to each parameter's
    `step`; the hyperparameters `learning_rate`, `b1`, `b2`, `eps` and
    `weight_decay` to the parameter group; `step` to `state.step`.
    optax decays the weight inside its update and torch before it; the
    two agree up to rounding. Returns `state`."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    opt_state = tree["opt_state"]
    adam, hp = opt_state["inner_state"]["0"], opt_state["hyperparams"]
    if float(hp["eps_root"]) != 0.0:
        raise ValueError(f"{path}: eps_root {float(hp['eps_root'])}; torch's AdamW has none")
    order = _copy_params(path, dict(_paths(_jax_tree(tree["params"]))), state)
    mu, nu = (dict(_paths(_jax_tree(adam[k]))) for k in ("mu", "nu"))
    leaves = dict(_paths(state.params))
    count = torch.tensor(float(adam["count"]), dtype=torch.float32)
    (group,) = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict({
        "state": {i: {"step": count.clone(),
                      "exp_avg": torch.empty_like(leaves[p]).copy_(mu[p]),
                      "exp_avg_sq": torch.empty_like(leaves[p]).copy_(nu[p])}
                  for i, p in enumerate(order)},
        "param_groups": [{**group, "lr": float(hp["learning_rate"]),
                          "betas": (float(hp["b1"]), float(hp["b2"])), "eps": float(hp["eps"]),
                          "weight_decay": float(hp["weight_decay"]),
                          "params": list(range(len(order)))}]})
    state.step = int(tree["step"])
    return state


# ------------------------------------------------ msgpack (flax's encoding)

_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3  # flax.serialization's ext type codes


class _Reader:
    """Big-endian cursor over a msgpack byte string."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)


def _flax_ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = _unpack(_Reader(payload))
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == _FLAX_NDARRAY:
        return _flax_ndarray(payload)
    if code == _FLAX_NPSCALAR:
        return _flax_ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unpack(r: _Reader):
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode()
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return r.take(r.uint(1 << (b - 0xC4)))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.uint(1 << (b - 0xC7))
        code = r.sint(1)
        return _ext(code, r.take(n))
    if b == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if b == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if 0xCC <= b <= 0xCF:  # uint 8/16/32/64
        return r.uint(1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:  # int 8/16/32/64
        return r.sint(1 << (b - 0xD0))
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.sint(1)
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return r.take(r.uint(1 << (b - 0xD9))).decode()
    if b in (0xDC, 0xDD):  # array 16/32
        return [_unpack(r) for _ in range(r.uint(2 if b == 0xDC else 4))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def msgpack_restore(data: bytes):
    """Decode a msgpack document as flax's `msgpack_restore` does: maps,
    arrays, str/bin, ints, floats, nil and booleans, with flax's ndarray
    (ext 1) and numpy scalar (ext 3) types as numpy values. Arrays that
    flax splits into chunks (over 2^30 bytes) are not reassembled."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out
