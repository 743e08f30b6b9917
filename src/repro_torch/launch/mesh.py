"""Production mesh shapes (single-pod 16x16, multi-pod 2x16x16), mirroring
``repro.launch.mesh``.

A mesh here is a record of axis names and sizes, nothing more: the dry run
(``launch/dryrun.py``) needs only the sizes to divide each tensor's
dimensions by its partition spec, and the port runs on one card, so no
process group or ``DeviceMesh`` is built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axes(self) -> Tuple[Tuple[str, ...], str, int, int]:
        """(dp_axes, tp_axis, dp_size, tp_size): every axis but ``model``
        carries the batch and FSDP shards."""
        dp_axes = tuple(a for a in self.axis_names if a != "model")
        shape = self.shape
        return (dp_axes, "model", math.prod(shape[a] for a in dp_axes),
                shape["model"])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def mesh_axes(multi_pod: bool) -> Tuple[Tuple[str, ...], str, int, int]:
    """(dp_axes, tp_axis, dp_size, tp_size) for a production mesh."""
    return make_production_mesh(multi_pod=multi_pod).axes()


def make_debug_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """A (data, model) mesh of local cards; dp * tp must not exceed them."""
    have = torch.cuda.device_count()
    if dp < 1 or tp < 1 or dp * tp > have:
        raise RuntimeError(
            f"a {dp}x{tp} mesh needs {dp * tp} CUDA cards; "
            f"torch.cuda.device_count() is {have}")
    return Mesh(("data", "model"), (dp, tp))
