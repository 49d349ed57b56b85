"""The single-controller mesh's collectives, the logical-axis sharding
rules and the placement of tensors over a mesh (the JAX package's
``distributed``): the sharded page pool's split-KV attention, the
expert-parallel MoE's sum over mesh axes (:func:`psum`), and
:func:`shard_tensor` / :func:`unshard_tensor`, which cut a tensor into the
pieces of a (mesh, spec) and put them back together (the MoE bodies and
``checkpoint.restore(shardings=)`` place through them)."""

from repro_torch.distributed.collectives import (KVShardSpec,
                                                 compressed_grad_sync,
                                                 compressed_psum, psum,
                                                 scatter_pages_sharded,
                                                 shard_pages,
                                                 split_kv_attention,
                                                 split_kv_paged_partial,
                                                 unshard_pages)
from repro_torch.distributed.sharding import (NamedSharding, Rules,
                                              current_mesh, current_rules,
                                              kv_shard_rules, logical_spec,
                                              long_context_rules,
                                              param_specs, serving_rules,
                                              shard, shard_tensor,
                                              training_rules,
                                              unshard_tensor, use_rules)

__all__ = [
    "KVShardSpec", "compressed_grad_sync", "compressed_psum", "psum",
    "scatter_pages_sharded", "shard_pages", "split_kv_attention",
    "split_kv_paged_partial", "unshard_pages", "NamedSharding", "Rules",
    "current_mesh", "current_rules", "kv_shard_rules", "logical_spec",
    "long_context_rules", "param_specs", "serving_rules", "shard",
    "shard_tensor", "training_rules", "unshard_tensor", "use_rules",
]
