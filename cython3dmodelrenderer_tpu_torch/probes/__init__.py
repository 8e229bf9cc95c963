"""Calibration probes on the card: counterparts of ``tools/probes/``'s two
Pallas kernels.

* ``vpu_cal`` (kernel P2, ``csrc/vpu_cal.cu``): the achieved f32 instruction
  rate of a chained multiply-add / compare-select mix, B1's mix;
* ``epi_prims`` (kernel P1, ``csrc/epi_prims.cu``): the per-replica cost of
  the raster epilogue's primitives (lane reductions, rolls, segmented sums)
  over a (16, 32, 128) f32 tile.

Each runs on the card as a script (``python -m
cython3dmodelrenderer_tpu_torch.probes.vpu_cal``) and fails without one.
Importing a module runs nothing.
"""
