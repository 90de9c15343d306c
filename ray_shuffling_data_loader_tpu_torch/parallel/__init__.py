"""Data and sequence parallelism over ``torch.distributed`` process groups:
named-axis meshes (``mesh``) and the replicated-parameter trainer
(``trainer``)."""
