"""Set-up spent building or finding and loading the CUDA kernels, in
seconds: ``kernel_build_s + kernel_load_s`` of the program's counters
(``cuda_build.load``), as this run's own set-up left them. A ``--trace 1``
run finds every library built by an earlier run, so this reads the warm
load (finding and opening the libraries), not nvcc: the build shows only
in the first run's ``setup_s``. None where the program keeps no
counters. Moves setup_s."""


def read(_trace):
    from cython3dmodelrenderer_tpu_torch.utils import timing

    counters = getattr(timing, "counters", None)
    if counters is None:
        return None
    return float(counters["kernel_build_s"] + counters["kernel_load_s"])
