"""Runtime services of the port: checkpointing, elastic re-meshing and
straggler mitigation."""
from .checkpoint import CheckpointManager, flat_to_tree, tree_to_flat  # noqa: F401,E501
from .elastic import (StragglerMonitor, WorkQueue,  # noqa: F401
                      make_mesh_from_devices, remesh_tree)
