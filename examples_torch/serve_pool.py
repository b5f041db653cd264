"""Continuous-batching serving: a fixed pool of decode slots serves a
queue of requests, each at its own position (per-slot KV positions), on
the card (default) or on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --requests 12
    PYTHONPATH=src python examples_torch/serve_pool.py
    PYTHONPATH=src python examples_torch/serve_pool.py --device cpu
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
