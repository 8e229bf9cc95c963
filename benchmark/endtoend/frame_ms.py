"""Time per delivered frame: the whole measured window over the frames
completed in it. A frame counts when ``Renderer.render`` has returned and
the harness has synchronised on its uint8 image, which stays on the
card."""


def read(window):
    if window.unit != "frame" or not window.units:
        return None
    return 1e3 * window.seconds / window.units
