"""Grid operators, particle<->grid transfers, binning and the kernels' wrappers."""
