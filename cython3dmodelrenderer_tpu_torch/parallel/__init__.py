"""Multi-view rendering: pose-sequence and turntable sweeps (``multiview``)."""
