"""The partitioned spatial join launcher with partition-level
checkpointing, in one process (a world of one rank). The launcher accepts
any registered intermediate filter; APRIL's verdicts run sharded over the
ranks on the device (the CUDA kernels on the card), the others run their
batched verdicts per partition.

    PYTHONPATH=src python examples_torch/distributed_join.py
    PYTHONPATH=src python examples_torch/distributed_join.py --device cpu

For more ranks, run the launcher under ``torchrun`` (gloo on host tensors;
with ``--device cuda`` each rank takes ``cuda:<LOCAL_RANK>``):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
        repro_torch.launch.spatial_join --device cpu --count-r 400 \\
        --count-s 600 --n-order 9 --ckpt-dir DIR
"""
import argparse
import tempfile

from repro_torch.launch.spatial_join import run_join
from repro_torch.spatial.distributed import make_join_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the join runs: cuda (default) or cpu")
    ap.add_argument("--count-r", type=int, default=400)
    ap.add_argument("--count-s", type=int, default=600)
    ap.add_argument("--n-order", type=int, default=9)
    ap.add_argument("--parts", type=int, default=2)
    args = ap.parse_args(argv)
    mesh = make_join_mesh(device=args.device)
    kw = dict(n_order=args.n_order, parts=args.parts, count_r=args.count_r,
              count_s=args.count_s, mesh=mesh)
    print(f"ranks: {mesh.size}, device {mesh.device}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/april_join_ckpt"
        results, totals = run_join("T1", "T2", method="april", ckpt_dir=ckpt,
                                   **kw)
        print(f"join results: {len(results)} pairs")
        print(f"filter verdict counts: {totals}")
        print("re-running resumes from the partition checkpoint:")
        resumed, _ = run_join("T1", "T2", ckpt_dir=ckpt, **kw)
    print("the same launcher with the RI filter on the host backend:")
    ri, _ = run_join("T1", "T2", method="ri", backend="numpy", **kw)
    return {"april": results, "resumed": resumed, "ri": ri}


if __name__ == "__main__":
    main()
