"""Training data of the port: the precomputed ``.npz`` cache and resolution-bucketed batching."""
