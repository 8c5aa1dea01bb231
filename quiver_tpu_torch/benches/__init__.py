"""The port's benchmark entry points (``benches/`` of the JAX package stays
the reference's). Each runs only on a CUDA card:

    python -m quiver_tpu_torch.bench                    # headline QPS
    python -m quiver_tpu_torch.benches.bench_latency    # per-batch latency
    python -m quiver_tpu_torch.benches.probe            # the probe kernels
"""
