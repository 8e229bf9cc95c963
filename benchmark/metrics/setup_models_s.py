"""Set-up spent in ``Model.from_state``, in seconds: ``model_state_s`` of
the program's counters, as this run's own set-up left them (a frame
cell hands its 16 posed copies over there). None where the program
keeps no counters. Moves setup_s."""


def read(_trace):
    from cython3dmodelrenderer_tpu_torch.utils import timing

    counters = getattr(timing, "counters", None)
    if counters is None:
        return None
    return float(counters["model_state_s"])
