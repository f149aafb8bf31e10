"""Entry points of the port: ``python -m repro_torch.launch.serve``, and
the named meshes over a ``torch.distributed`` world (``mesh``)."""
