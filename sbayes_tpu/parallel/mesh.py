"""Multi-device scaling: chain-axis sharding over a device mesh.

The reference's only distributed machinery is OS processes + pickled pipes
(sbayes/mcmc_setup.py MCMCChainProcess, cli.py Pool). Here distribution is
SPMD: chains (ensembles, MC3 ladders, warm-up races) are a batch axis laid
out over a ``jax.sharding.Mesh``; XLA inserts the (minimal) collectives.
Each chain's state is tiny and fully chain-parallel, so the layout is pure
data parallelism with zero cross-device traffic in the hot loop —
the only communication is at MC3 swap boundaries, where per-chain scalars
(log_lh, log_prior) are gathered and a permutation of the chain axis is
applied.

For very large datasets (e.g. the 10k x 5k synthetic scale-up) the objects
axis of the one-hot tensor and count einsums can additionally be sharded —
see ``data_mesh`` below.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
DATA_AXIS = "objects"


def chain_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) devices with a 'chains' axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def data_mesh(n_chain_shards: int, n_data_shards: int, devices=None) -> Mesh:
    """2-D mesh: chains x objects, for sharding both the ensemble and the
    data axes of very large problems."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_chain_shards * n_data_shards]).reshape(
        n_chain_shards, n_data_shards
    )
    return Mesh(devices, (CHAIN_AXIS, DATA_AXIS))


def auto_chain_mesh(n_chains: int, devices=None) -> Optional[Mesh]:
    """The production auto-sharding policy (reference counterpart: the CLI
    process pool, sbayes/cli.py:104-109, and one-process-per-MC3-chain,
    mcmc_setup.py:274-282 — here one SPMD program over the chain axis).

    Returns a 1-D 'chains' mesh over ALL devices when the chain count
    splits evenly, else None (no sharding). Partial-device meshes are
    deliberately not used: model constants replicate over every device
    once, and a later program on a device *subset* would then see
    incompatible placements (jax rejects mixed device sets).
    Kill switch: SBAYES_TPU_SHARDING=off.
    """
    import os

    if os.environ.get("SBAYES_TPU_SHARDING", "").lower() in ("off", "0", "none"):
        return None
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_dev <= 1 or n_chains <= 1 or n_chains % n_dev != 0:
        return None
    return chain_mesh(n_dev, devices=devices)


def shard_chain_batch(tree, mesh: Mesh):
    """Place a chain-batched PyTree so the leading axis is split over the
    mesh's chain axis. Works for ChainState, OperatorStats, key batches."""
    sharding = NamedSharding(mesh, P(CHAIN_AXIS))
    return jax.device_put(tree, sharding)


def replicate(tree, mesh: Mesh):
    """Fully replicate a PyTree over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
