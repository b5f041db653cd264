"""Online spatial-join serving: warm device-resident stores behind an LRU
cache, micro-batched selection/window/intersects/within queries,
incremental inserts/deletes patching the CSR interval stores in place, on
the card (default) or on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve_join --queries 200
    PYTHONPATH=src python examples_torch/serve_spatial.py
    PYTHONPATH=src python examples_torch/serve_spatial.py --device cpu
"""
from repro_torch.launch.serve_join import main

if __name__ == "__main__":
    main()
