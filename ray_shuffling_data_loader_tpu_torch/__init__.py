"""PyTorch/CUDA port of the shuffling data loader, for NVIDIA Hopper.

A second package beside ``ray_shuffling_data_loader_tpu`` (the JAX
reference, which it never imports). It carries the DLRM train path end to
end: Parquet -> seeded map/reduce shuffle (``shuffle``) -> per-rank queue
(``multiqueue``) -> exact re-batching (``dataset``) -> staged host-to-device
copies (``device_dataset``) -> DLRM (``models``) with a hand-written CUDA
embedding row gather (``ops.embedding``, ``kernels/gather.cu``) -> Adam
(``train``).

Entry points take ``device=None``, meaning ``torch.device("cuda")``, and
raise when CUDA is absent; pass ``device="cpu"`` to run on the host, where
each kernel's plain PyTorch version stands in.

Importing this package imports no submodule; import what you use.
"""

__version__ = "0.1.0"
