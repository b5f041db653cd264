from .synthetic import (  # noqa: F401
    DATASET_SPECS, PolygonDataset, iter_dataset_chunks, make_chunked_dataset,
    make_dataset, make_linestrings)
