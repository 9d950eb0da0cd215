"""Data-parallel and model-sharded training and scoring on
``torch.distributed`` (ROADMAP queue 1 item 10, done): the runtime and the
(data, model) mesh (``mesh.py``), the collectives over its groups
(``collectives.py``), the placement rules (``sharding.py``), the
row-sharded lookups, the sparse gradient exchange and the routed pairs of
the sparse-fused path (``embedding_shard.py``), and ring attention over
the field axis (``ring_attention.py``). Sharded batch scoring is
``Trainer.predict`` under a mesh, driven by the CLI's ``predict``,
``recommend`` and ``serve`` (``serving.py``'s ``RankScorer``)."""

from deepfm_tpu_torch.parallel.embedding_shard import (
    make_a2a_lookup,
    make_a2a_lookup_packed,
    make_lookup_fn,
    make_packed_lookup_factory,
    make_psum_lookup,
    make_psum_lookup_packed,
    route_sorted_pairs,
    sparse_grad_exchange,
)
from deepfm_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    Group,
    Mesh,
    build_hybrid_mesh,
    build_mesh,
    check_multihost,
    initialize_distributed,
    multiprocess_env_configured,
    resolve_mesh,
)
from deepfm_tpu_torch.parallel.ring_attention import (
    field_block,
    ring_field_attention,
)
from deepfm_tpu_torch.parallel.sharding import (
    batch_rows,
    batch_shardings,
    check_batch,
    is_table_path,
    placement,
    replicated,
    slab_bounds,
    state_shardings,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_MODEL",
    "Group",
    "Mesh",
    "batch_rows",
    "batch_shardings",
    "build_hybrid_mesh",
    "build_mesh",
    "check_batch",
    "check_multihost",
    "field_block",
    "initialize_distributed",
    "is_table_path",
    "make_a2a_lookup",
    "make_a2a_lookup_packed",
    "make_lookup_fn",
    "make_packed_lookup_factory",
    "make_psum_lookup",
    "make_psum_lookup_packed",
    "multiprocess_env_configured",
    "placement",
    "replicated",
    "resolve_mesh",
    "ring_field_attention",
    "route_sorted_pairs",
    "slab_bounds",
    "sparse_grad_exchange",
    "state_shardings",
]
