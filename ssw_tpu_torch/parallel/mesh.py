"""Device mesh of the alignment engine: a (data, seq) grid of torch devices.

Axes (the reference is single-threaded, ref: src/main.c:462, so this layer
is the JAX package's own scale-out design, ssw_tpu/parallel/mesh.py):

  data  read batches (data parallelism: no per-column communication)
  seq   target columns (sequence parallelism for long targets: per-shard DP
        with halo re-compute and a best-hit merge, parallel/dist.py)

A device may fill more than one cell: on a host with one card, a mesh of
[cuda:0] * S runs the S sequence shards one after another on that card (as
the JAX tests' virtual CPU devices stand in for chips), and the CPU tests
build meshes of [cpu] * 8.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (data, seq) array of torch.device, with .shape["data"/"seq"]."""

    axis_names = ("data", "seq")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, seq), got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_mesh(data: int | None = None, seq: int = 1, devices=None) -> Mesh:
    """A data x seq mesh over `devices` (default: every CUDA device; raises
    without a card).  data defaults to len(devices) // seq."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh uses the CUDA devices by default and "
                "torch.cuda.is_available() is False; pass devices= (e.g. "
                "[torch.device('cpu')] * 8) to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d}: torch.cuda.is_available() "
                               f"is False")
    if data is None:
        data = len(devs) // seq
    if data < 1 or seq < 1 or data * seq > len(devs):
        raise ValueError(f"a {data} x {seq} mesh needs {data * seq} "
                         f"devices, got {len(devs)}")
    grid = np.empty(data * seq, dtype=object)
    grid[:] = devs[:data * seq]
    return Mesh(grid.reshape(data, seq))
