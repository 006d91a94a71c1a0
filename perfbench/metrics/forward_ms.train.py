"""Median ms a training step in voxelization and the forward (phases voxelize,
forward)."""
from perfbench.metrics import _read


def read(ctx):
    return _read.stage_ms(ctx, "train", ("voxelize", "forward"))
