"""Time per turntable view: the whole measured window over the views
completed in it. A sweep counts when ``Renderer.render_sequence`` has
returned and the harness has synchronised on its frames."""


def read(window):
    if window.unit != "view" or not window.units:
        return None
    return 1e3 * window.seconds / window.units
