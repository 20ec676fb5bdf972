"""repro_torch — the hierarchical-FL system on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``repro``, which stays beside it as the
reference.  The layout mirrors it module for module:

``data``        synthetic ECG/EEG datasets and the Table 2/3 partitioners
                (numpy-only copies, byte-equal output)
``utils``       nested-dict parameter trees in JAX's leaf order
``kernels``     hand-written CUDA kernels for the FedAvg reductions
                (``hier_aggregate``, ``hier_segment_aggregate``), each with
                its plain PyTorch version and a launch counter
``engine``      flat (N, D) update matrices, the device shard store, cohort
                training and the batched synchronous engine
``models``      the paper's 1-D CNN
``training``    loss and the elementwise optimizers
``federated``   clients, programs, evaluation and the scenario builder
``core``        EARA assignment, KLD objectives, LP solvers, accounting
``wireless``    the eq. 10-16 cost model

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller passes ``device="cpu"`` (``device.py``).
This package never imports JAX or the reference package.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
