"""A one-rank gloo process group in the test's own process, for the
tensor-parallel code paths that need a live group but no peers (the
model group of tp=1: every collective is the identity on its input).

    with world_of_one(tmp_path) as group:
        mlp_apply(params, x, tp_axis=group)

The group is torn down on leaving the block, so later tests in the same
process see no process group.
"""
import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'w1'}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
