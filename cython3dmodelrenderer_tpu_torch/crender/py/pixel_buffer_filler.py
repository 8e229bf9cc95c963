from ...fillers import (AdvancedPixelBufferFiller, EdgeOnlyPixelBufferFiller,
                       PixelBufferFiller)

__all__ = ["PixelBufferFiller", "AdvancedPixelBufferFiller",
           "EdgeOnlyPixelBufferFiller"]
