"""Runtime services of the port: checkpointing."""
from .checkpoint import CheckpointManager, flat_to_tree, tree_to_flat  # noqa: F401,E501
