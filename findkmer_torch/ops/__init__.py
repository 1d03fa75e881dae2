"""Device ops of the port: window extraction, dense histograms, kernels."""
