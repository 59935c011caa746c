"""The x-slab multi-device step, the counterpart of ``polystokes_tpu.parallel``.

One process drives a mesh given as a list of ``torch.device`` (a device may
repeat, as JAX's virtual CPU devices do: n slabs on one card, or on the
CPU in the tests).  ``sharding.sharded_step`` runs a step whose packed
apply is split into x-slabs, one a device, each given ``HALO_X`` planes
from its neighbours (``shard_apply``); ``dryrun.dryrun_multichip`` runs a
small sharded step as the JAX package's ``__graft_entry__`` does.
"""
from .shard_apply import exchange_halos, make_apply_packed_sharded, shardable
from .sharding import Mesh, check_mesh_pallas, make_mesh, pallas_shardable, shard_scene, sharded_step

__all__ = [
    "Mesh",
    "check_mesh_pallas",
    "exchange_halos",
    "make_apply_packed_sharded",
    "make_mesh",
    "pallas_shardable",
    "shard_scene",
    "shardable",
    "sharded_step",
]
