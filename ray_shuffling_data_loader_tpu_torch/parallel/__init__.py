"""Data, sequence and tensor parallelism over ``torch.distributed`` process
groups: named-axis meshes (``mesh``), Megatron tensor parallelism over the
``"model"`` axis (``tp``), the trainer (``trainer``) and the multi-rank dry
run (``dryrun``)."""
