from ...ops.illumination import (GuroIllumination, IlluminationDrawer,
                                NoIllumination)

__all__ = ["IlluminationDrawer", "NoIllumination", "GuroIllumination"]
