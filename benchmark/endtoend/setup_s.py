"""Start-up: from the harness's first statement (before PyTorch is
imported) to the first timed step: imports, CUDA's start, loading or
building the kernels, the inputs, ``Model.from_state`` and the warm-up."""


def read(window):
    return window.setup_s
