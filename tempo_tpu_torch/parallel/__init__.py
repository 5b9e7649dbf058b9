"""Multi-device serving. Counterpart of `tempo_tpu/parallel/`: the
(data, series) mesh of torch devices (`mesh`), the process serving mesh
and its config block (`serving`), and the product paths under a mesh
(`product`). Series sharding splits registry and sketch state by slot
range, with K1 launched once per shard; the data axis splits span
batches and reduces their deltas in shard order."""

from tempo_tpu_torch.parallel.mesh import (
    make_mesh,
    make_multihost_mesh,
    merge_sketch_states,
    mesh_fingerprint,
    shard_batch_arrays,
    sharded_query_range_step,
    sharded_serving_step,
    sharded_spanmetrics_step,
    validate_mesh_shape,
)
from tempo_tpu_torch.parallel.serving import MeshConfig, ServingMesh

__all__ = [k for k in dir() if not k.startswith("_")]
