"""Multi-view and multi-GPU rendering: pose-sequence and turntable sweeps
and view or triangle sharding (``multiview``) over a ``torch.distributed``
mesh (``mesh``)."""
