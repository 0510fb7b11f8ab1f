"""Sharded serving: thread a mesh through the engine (the port of
``repro/shard/``).

* ``build_mesh(MeshConfig)`` turns the runtime config into a
  ``launch.mesh.Mesh`` over the launched ranks (or ``None`` when sharding
  is off);
* ``shard_params`` slices the full weights to this rank's part at ``LLM``
  init -- serving uses pure TP (``fsdp=False``), training FSDP
  (``fsdp=True``); ``shard_opt_state`` slices the AdamW state (ZeRO-1),
  ``gather_tree`` is the inverse of both (sharded checkpoints);
* ``pool_shardings`` gives the rank's part of the paged KV pool (KV heads
  over "model"; block tables replicated, so the host-side ``PageManager``
  stays the one source of truth);
* ``make_host_mesh`` is the test factory; its ranks come from
  ``launch.mesh.spawn`` or ``torchrun``.

Correctness contract (``tests/test_torch_tp.py``): at ``tp=1`` greedy
outputs are bitwise the unsharded engine's; at ``tp>1`` the quantized
row-parallel GEMMs sum their int32 accumulators across ranks and take
globally exact scales, so integer-mode outputs stay bitwise too, and
greedy token streams equal the unsharded engine's.
"""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.shard.core import (
    build_mesh,
    gather_tree,
    local_config,
    mesh_axis_size,
    pool_shardings,
    shard_opt_state,
    shard_params,
    shard_tree,
    validate_mesh_config,
)
from repro_torch.shard.memory import describe_mesh, tree_device_bytes

__all__ = [
    "build_mesh",
    "describe_mesh",
    "gather_tree",
    "local_config",
    "make_host_mesh",
    "make_production_mesh",
    "mesh_axis_size",
    "pool_shardings",
    "shard_opt_state",
    "shard_params",
    "shard_tree",
    "tree_device_bytes",
    "validate_mesh_config",
]
