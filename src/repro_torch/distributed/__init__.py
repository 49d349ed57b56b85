"""The single-controller mesh's collectives and the logical-axis sharding
rules (the JAX package's ``distributed``)."""

from repro_torch.distributed.collectives import (KVShardSpec,
                                                 compressed_grad_sync,
                                                 compressed_psum,
                                                 scatter_pages_sharded,
                                                 shard_pages,
                                                 split_kv_attention,
                                                 split_kv_paged_partial,
                                                 unshard_pages)
from repro_torch.distributed.sharding import (Rules, current_mesh,
                                              current_rules, kv_shard_rules,
                                              logical_spec, long_context_rules,
                                              param_specs, serving_rules,
                                              shard, training_rules,
                                              use_rules)

__all__ = [
    "KVShardSpec", "compressed_grad_sync", "compressed_psum",
    "scatter_pages_sharded", "shard_pages", "split_kv_attention",
    "split_kv_paged_partial", "unshard_pages", "Rules", "current_mesh",
    "current_rules", "kv_shard_rules", "logical_spec", "long_context_rules",
    "param_specs", "serving_rules", "shard", "training_rules", "use_rules",
]
