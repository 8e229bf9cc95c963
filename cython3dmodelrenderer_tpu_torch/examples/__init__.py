"""Runnable examples: ``python -m cython3dmodelrenderer_tpu_torch.examples.
turntable`` (a view sweep on the card) and ``.multichip`` (view and
triangle sharding over spawned ranks)."""
