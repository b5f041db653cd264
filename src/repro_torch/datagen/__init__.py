from .synthetic import DATASET_SPECS, PolygonDataset, make_dataset  # noqa: F401
