"""Frame-path operators: geometry, plane rows, binning, kernels, shading."""
