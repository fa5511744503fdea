"""Partitioned serving over a list of torch devices (counterpart of the JAX
package's parallel/).

`mesh` holds the partitioner and the query factories, `collectives` the
sums and exchanges between partitions, and `mesh_engine.MeshQueryEngine`
wraps them with the single-device engine's serving (tombstone filters,
delta refresh, ladder re-serves, warmup).
"""

from .mesh_engine import MeshQueryEngine

__all__ = ["MeshQueryEngine"]
