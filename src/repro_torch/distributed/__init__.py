"""Tensor-parallel serving over ``torch.distributed`` (counterpart of the
serving rules of ``repro.distributed.sharding``)."""
from .sharding import (MeshDivisibilityError, TPGroup, gather_tp,
                       serve_attn_sharded, serve_mlp_sharded,
                       shard_serve_params, validate_serve_mesh)

__all__ = ["MeshDivisibilityError", "TPGroup", "gather_tp",
           "serve_attn_sharded", "serve_mlp_sharded", "shard_serve_params",
           "validate_serve_mesh"]
