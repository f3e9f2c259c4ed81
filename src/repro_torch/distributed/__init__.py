"""Sharding over ``torch.distributed``: tensor-parallel serving and the
training rule table (counterpart of ``repro.distributed.sharding``)."""
from .sharding import (Mesh, MeshDivisibilityError, MeshGroup,
                       NamedSharding, ShardCtx, TPGroup, constrain,
                       gather_tp, logical_to_spec, param_specs,
                       serve_attn_sharded, serve_mlp_sharded,
                       shard_serve_params, validate_serve_mesh)

__all__ = ["Mesh", "MeshDivisibilityError", "MeshGroup", "NamedSharding",
           "ShardCtx", "TPGroup", "constrain", "gather_tp",
           "logical_to_spec", "param_specs", "serve_attn_sharded",
           "serve_mlp_sharded", "shard_serve_params", "validate_serve_mesh"]
