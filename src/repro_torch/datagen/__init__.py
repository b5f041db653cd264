from .synthetic import (  # noqa: F401
    DATASET_SPECS, PolygonDataset, make_dataset, make_linestrings)
