"""The (dp, trial) mesh over the ranks of the process group.

Counterpart of ``nanopore_tpu/parallel/mesh.py``.  It replaces the
reference's batch-system parallelism (singleMachine / parasol /
gridEngine over a shared filesystem, reference Makefile:1-3): reads
shard data-parallel over the ``dp`` axis, EM random-restart trials shard
over the ``trial`` axis (the reference forks them as jobTree children,
utils.py:514,528), and the expectation sums all-reduce over ``dp``.

The JAX mesh lays devices out; this one lays out ranks, one process per
host, each running its kernels on its own card(s).  The port places work
by rank, not by sharding, so the JAX package's ``batch_sharding``,
``trial_sharding`` and ``replicated`` (``NamedSharding``s) have no
counterpart, nor does ``make_mesh``'s ``n_devices`` (a prefix of the
device list): a mesh spans every rank of the group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from nanopore_tpu_torch.parallel.distributed import process_info

DP_AXIS = "dp"
TRIAL_AXIS = "trial"


@dataclass
class Mesh:
    """Rank ``r`` sits at (dp index ``r // trial``, trial index
    ``r % trial``).  ``dp_group`` holds the ranks of this rank's trial
    column (they share its trials and split the reads), ``trial_group``
    those of its dp row (they share its reads and split the trials);
    each is None where it holds this rank alone."""

    shape: dict  # {DP_AXIS: dp, TRIAL_AXIS: trial}
    coords: tuple[int, int]  # this rank's (dp index, trial index)
    dp_group: object = None
    trial_group: object = None


def mesh_shape(n: int, n_trials: int = 1) -> tuple[int, int]:
    """(dp, trial) for ``n`` ranks: the trial axis gets the largest
    divisor of n that is <= n_trials; the rest goes to data parallelism."""
    trial = 1
    for cand in range(min(n_trials, n), 0, -1):
        if n % cand == 0:
            trial = cand
            break
    return n // trial, trial


def make_mesh(n_trials: int = 1) -> Mesh:
    """A (dp, trial) mesh over every rank of the process group (a 1 x 1
    mesh in a single process).  Every rank creates every group, in the
    same order, as ``torch.distributed.new_group`` requires, so every
    rank must call this at the same point."""
    rank, world = process_info()
    dp, trial = mesh_shape(world, n_trials)
    grid = np.arange(world).reshape(dp, trial)
    mesh = Mesh({DP_AXIS: dp, TRIAL_AXIS: trial},
                (rank // trial, rank % trial))
    if world == 1:
        return mesh
    for col in range(trial):
        ranks = grid[:, col].tolist()
        group = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            mesh.dp_group = group
    for row in range(dp):
        ranks = grid[row].tolist()
        group = dist.new_group(ranks) if trial > 1 else None
        if rank in ranks:
            mesh.trial_group = group
    return mesh


def pad_batch_to(arrays: dict, multiple: int) -> dict:
    """Pad leading dims to a multiple so they divide the dp axis."""
    out = {}
    for key, arr in arrays.items():
        b = arr.shape[0]
        pad = (-b) % multiple
        if pad:
            pad_block = np.zeros((pad,) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([np.asarray(arr), pad_block], axis=0)
        out[key] = arr
    return out
