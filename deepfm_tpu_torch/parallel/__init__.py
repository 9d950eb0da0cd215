"""Data-parallel training on ``torch.distributed`` (ROADMAP queue 1 item
10(a)): the runtime and the mesh (``mesh.py``), the collectives
(``collectives.py``), the placement rules (``sharding.py``) and the sparse
gradient exchange (``embedding_shard.py``). Model-sharded tables wait for
item 10(b), ring attention for 10(c)."""

from deepfm_tpu_torch.parallel.embedding_shard import (
    make_lookup_fn,
    make_packed_lookup_factory,
    sparse_grad_exchange,
)
from deepfm_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    build_hybrid_mesh,
    build_mesh,
    check_multihost,
    initialize_distributed,
    multiprocess_env_configured,
    resolve_mesh,
)
from deepfm_tpu_torch.parallel.sharding import (
    batch_rows,
    check_batch,
    is_table_path,
    placement,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_MODEL",
    "Mesh",
    "batch_rows",
    "build_hybrid_mesh",
    "build_mesh",
    "check_batch",
    "check_multihost",
    "initialize_distributed",
    "is_table_path",
    "make_lookup_fn",
    "make_packed_lookup_factory",
    "multiprocess_env_configured",
    "placement",
    "resolve_mesh",
    "sparse_grad_exchange",
]
