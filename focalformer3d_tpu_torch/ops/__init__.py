"""Ported ops: voxelization, sparse-conv index build and apply, sampling."""
