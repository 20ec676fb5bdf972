"""repro_torch — the hierarchical-FL system on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``repro``, which stays beside it as the
reference.  The layout mirrors it module for module:

``data``        synthetic ECG/EEG datasets and the Table 2/3 partitioners
                (numpy-only copies, byte-equal output)
``utils``       nested-dict parameter trees in JAX's leaf order
``kernels``     hand-written CUDA kernels — the FedAvg reductions
                (``hier_aggregate``, ``hier_segment_aggregate``),
                ``flash_attention`` and ``topk_gating`` — each with its
                plain PyTorch version and a launch counter
``engine``      flat (N, D) update matrices, the device shard store, cohort
                training and the batched synchronous engine
``models``      the paper's 1-D CNN, and the dense transformer stack
                (config, modules, attention, MLP, prefill/decode)
``configs``     the model zoo's configurations (copied as data)
``serving``     the batched greedy ``ServeEngine``
``launch``      the serving launcher (``python -m repro_torch.launch.serve``)
``telemetry``   span tracing and metrics (stdlib copies of the reference's)
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
